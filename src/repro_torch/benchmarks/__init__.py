"""The paper's measurement path on the port's kernels: STREAM bandwidth
(Fig. 4/6), FMA/DPA2/DPA4 peak (Fig. 5/7) and launch latency (Fig. 8).

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
"""

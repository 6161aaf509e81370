"""Paper Fig. 5 / Fig. 7 (Sec. 5.2/5.4): peak compute across DPA variants.

FMA f32, DPA2 (bf16 -> f32) and DPA4 (int8 -> int32) products of
512x512x512 on the hand-written ``dpa_matmul`` kernel
(``csrc/dpa_matmul.cu``, through ``kernels/dpa_matmul/ops``), from the
reference's f32 normal inputs (the wrapper casts them to bf16 or int8 as
the reference does, inside the timed call). Gop/s counts 2*M*K*N over the
median wall time of one call that ends at ``torch.cuda.synchronize()``.

The derived column names the H100 SXM data sheet's dense peak for each
variant: 67 TFLOP/s f32 on the CUDA cores (not TF32), 989 TFLOP/s bf16 and
1979 TOP/s int8 on the tensor cores. They are the data sheet's, not
readings. With ``device="cpu"`` the plain versions run on the host.
"""
import numpy as np
import torch

from repro_torch.benchmarks.common import BenchRows, time_fn
from repro_torch.core.device import resolve_device
from repro_torch.kernels.dpa_matmul import ops as dpa_ops

M = K = N = 512
#: H100 SXM data sheet, dense: f32 FFMA, bf16 and int8 tensor cores
H100_PEAKS = {"fma_f32": 67e12, "dpa2": 989e12, "dpa4": 1979e12}


def run(device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(M, K)), dtype=torch.float32).to(dev)
    b = torch.as_tensor(rng.normal(size=(K, N)), dtype=torch.float32).to(dev)
    flops = 2 * M * K * N
    out = BenchRows()
    for variant in ("fma_f32", "dpa2", "dpa4"):
        t = time_fn(dpa_ops.matmul, a, b, variant=variant)
        gops = flops / t / 1e9
        out.record(f"peak/{variant}/{M}x{K}x{N}", t,
                   f"{gops:.1f}Gop/s;H100_datasheet_peak="
                   f"{H100_PEAKS[variant] / 1e12:.0f}Top/s",
                   compiles=dpa_ops.stats.compiles("dpa/matmul"))
    return out


if __name__ == "__main__":
    run()

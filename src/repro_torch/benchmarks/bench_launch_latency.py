"""Paper Fig. 8 (Sec. 5.5): kernel launch latency.

On DALEK this is the OpenCL enqueue-to-start latency (5-90 us across GPUs).
The rows here are its PyTorch/CUDA analogues, each the wall time of a call
on an 8x8 f32 tensor that ends at ``torch.cuda.synchronize()``:

- ``launch/eager_dispatch``: ``x + 1.0`` through PyTorch's eager dispatcher
  (one library kernel); median of 20 calls after 3 warm-up calls.
- ``launch/kernel_dispatch``: the hand-written ``stream_copy`` kernel with
  ``block_rows=8``, through its ``ctypes`` wrapper; median of 5 after 2.
- ``launch/first_launch``: in a fresh Python process whose CUDA context is
  already up, the ``ctypes`` load of the already built STREAM library plus
  the first launch of ``stream_copy`` and its completion: the first-launch
  cost a user hits (the reference measured ``jax.jit`` trace+compile). One
  reading.

With ``device="cpu"`` the same calls run the plain versions on the host,
so the rows then read host dispatch, not a launch.
"""
import os
import pathlib
import subprocess
import sys

import torch

from repro_torch.benchmarks.common import BenchRows, time_fn
from repro_torch.core.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.stream import stream as sk

SRC = pathlib.Path(__file__).resolve().parents[2]

_FIRST_LAUNCH = """
import sys, time, torch
from repro_torch.kernels.stream import stream
dev = torch.device(sys.argv[1])
x = torch.zeros((8, 8), dtype=torch.float32, device=dev)
if dev.type == "cuda":
    torch.cuda.synchronize()
t0 = time.perf_counter()
y = stream.stream_copy(x, block_rows=8)
if dev.type == "cuda":
    torch.cuda.synchronize()
dt = time.perf_counter() - t0
assert stream.launches["stream_copy"] == (dev.type == "cuda")
print(dt)
"""


def first_launch(dev) -> float:
    """Seconds of the first ``stream_copy`` in a fresh process (library
    load + launch + completion on the card; the plain version on the
    host)."""
    if dev.type == "cuda":
        build.build("stream")          # built already: the load is timed
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _FIRST_LAUNCH, str(dev)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"first-launch process failed:\n{proc.stderr}")
    return float(proc.stdout.strip().splitlines()[-1])


def run(device=None):
    dev = resolve_device(device)
    out = BenchRows()
    x = torch.zeros((8, 8), dtype=torch.float32, device=dev)

    t = time_fn(lambda v: v + 1.0, x, warmup=3, iters=20)
    out.record("launch/eager_dispatch", t, f"torch-eager;{dev.type}")

    t = time_fn(lambda: sk.stream_copy(x, block_rows=8), warmup=2, iters=5)
    out.record("launch/kernel_dispatch", t,
               "hand-written-kernel" if dev.type == "cuda"
               else "plain-version;cpu")

    out.record("launch/first_launch", first_launch(dev),
               f"fresh-process-load+launch;{dev.type}")
    return out


if __name__ == "__main__":
    run()

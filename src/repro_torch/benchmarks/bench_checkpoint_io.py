"""Paper Fig. 9 (Sec. 5.6): SSD throughput -> checkpoint I/O.

Sequential write/read of a checkpoint (the cluster's real SSD workload) +
many-small-leaves variant (random-access pattern), as the reference bench
does, through the port's ``checkpoint.ckpt``: a 64 MB f32 leaf and 256
leaves of 4 KB. The trees live on the device, so a write includes the
copy to the host and a read the copy back (the leaves' device), and each
row ends when the last copy is done. The files go to a fresh temporary
directory under ``TMPDIR``.
"""
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.benchmarks.common import BenchRows, time_fn
from repro_torch.checkpoint import ckpt
from repro_torch.core.device import resolve_device


def run(device=None):
    dev = resolve_device(device)
    out = BenchRows()
    big = {"w": torch.as_tensor(np.random.default_rng(0).normal(
        size=(64, 1024, 256)), dtype=torch.float32).to(dev)}   # 64 MB
    small = {f"l{i}": torch.zeros((1024,), dtype=torch.float32, device=dev)
             for i in range(256)}
    nbytes = 64 * 1024 * 256 * 4
    for name, tree, size in (("seq", big, nbytes),
                             ("small_leaves", small, 256 * 4096)):
        last = next(reversed(tree.values()))
        d = tempfile.mkdtemp()
        try:
            # save copies every leaf to the host before it writes; a
            # restored tree's last leaf is the last copy to the device
            t_w = time_fn(lambda: (ckpt.save(tree, d, 1), last)[1],
                          warmup=1, iters=3)
            t_r = time_fn(lambda: next(reversed(
                ckpt.restore(tree, d)[0].values())), warmup=1, iters=3)
            out.record(f"ckpt/{name}/write", t_w,
                       f"{size / t_w / 1e6:.0f}MB/s;{dev.type}")
            out.record(f"ckpt/{name}/read", t_r,
                       f"{size / t_r / 1e6:.0f}MB/s;{dev.type}")
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return out


if __name__ == "__main__":
    run()

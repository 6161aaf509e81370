"""Plain PyTorch version of the dpa_matmul kernel.

The wrapper uses it for CPU tensors only; the tests and ``chip_smoke.py``
hold the CUDA kernel against it. ``fma_f32`` is a true f32 product: on the
card it refuses to run while TF32 is allowed for matmuls. ``dpa2`` rounds
the inputs to bf16 and accumulates their exact products in f32. ``dpa4``
rounds to int8 and accumulates in f64, which is exact while the sum stays
below 2**53 (int8 products over any K below 2**38), then casts to int32.
"""
from __future__ import annotations

import torch


def matmul(a, b, variant="dpa2"):
    if variant == "fma_f32":
        if a.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("fma_f32's plain version needs "
                               "torch.backends.cuda.matmul.allow_tf32 = False")
        return torch.matmul(a.float(), b.float())
    if variant == "dpa2":
        return torch.matmul(a.to(torch.bfloat16).float(),
                            b.to(torch.bfloat16).float())
    if variant == "dpa4":
        return torch.matmul(a.to(torch.int8).double(),
                            b.to(torch.int8).double()).to(torch.int32)
    raise ValueError(variant)

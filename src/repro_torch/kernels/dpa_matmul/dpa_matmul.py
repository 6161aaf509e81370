"""Wrapper for the Hopper dot-product-accumulate matmul
(``csrc/dpa_matmul.cu``).

``dpa_matmul`` casts its inputs as the reference does (``dpa_matmul.py:
49-60``), checks the reference's block divisibility (raising
``ValueError`` where the reference asserts), allocates the output, launches
the kernel on the current CUDA stream and counts the launch in
``launches[variant]``. A CPU tensor goes to the plain version
(``ref.matmul``); a CUDA tensor goes to the kernel or raises. The block
sizes are the reference's TPU tiling: they only decide which shapes are
accepted, the kernel tiles by its own sizes.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dpa_matmul import ref

#: (input dtype, output dtype, kernel code) of each variant
VARIANTS = {
    "fma_f32": (torch.float32, torch.float32, 0),
    "dpa2": (torch.bfloat16, torch.float32, 1),
    "dpa4": (torch.int8, torch.int32, 2),
}

#: kernel launches since the last reset, by variant (callers zero them)
launches: Dict[str, int] = dict.fromkeys(VARIANTS, 0)


def _kernel():
    fn = build.load("dpa_matmul").dpa_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def dpa_matmul(a, b, *, variant="dpa2", block_m=128, block_n=128,
               block_k=256):
    """a: [M,K], b: [K,N] -> [M,N] in the accumulator dtype.

    variant: fma_f32 | dpa2 (bf16) | dpa4 (int8)."""
    if variant not in VARIANTS:
        raise ValueError(variant)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"dpa_matmul takes [M,K] @ [K,N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(f"shape (M {m}, N {n}, K {k}) is not a multiple of "
                         f"the blocks ({bm}, {bn}, {bk})")
    in_dtype, out_dtype, code = VARIANTS[variant]
    if a.device.type == "cpu":
        return ref.matmul(a, b, variant)
    if a.device.type != "cuda":
        raise ValueError(f"dpa_matmul: no kernel for {a.device}")
    a = a.to(in_dtype).contiguous()
    b = b.to(in_dtype).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       code, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dpa_matmul kernel launch failed: cudaError {rc}")
    launches[variant] += 1
    return out

"""Wrapper for the Hopper flash attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` checks its inputs, allocates the output, launches the
kernel on the current CUDA stream and counts the launch in ``launches``.
A CPU tensor goes to the plain version (``ref.attention``); a CUDA tensor
goes to the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

#: kernel launches since the last reset (plain integer; callers zero it)
launches = 0

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q_offset, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,H,S,D], k/v [B,Hkv,T,D]")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(f"kv heads {k.shape[1]} must divide q heads {h}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """softmax(q kᵀ/√D) v over [B,H,S,D] q and [B,Hkv,T,D] k, v.

    Causal and sliding-window masks use query position ``q_offset + i`` and
    key position j; query head h reads kv head ``h // (H // Hkv)``. The
    kernel keeps the running max, denominator and accumulator in f32 and
    writes q's dtype."""
    global launches
    _check(q, k, v, q_offset, window)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, h, k.shape[1], s, k.shape[2], d,
                       int(q_offset), int(causal), int(window or 0),
                       _DTYPES[q.dtype],
                       torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out

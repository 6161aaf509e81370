"""Wrapper for the Hopper flash attention kernels
(``csrc/flash_attention.cu``).

``flash_attention`` checks its inputs, picks the kernel's route and tile
with ``plan`` from the shape, dtype and the inputs' alignment and hands
them to ``launch``, which allocates the output, launches the kernel on the
current CUDA stream and counts the launch in ``launches``,
``route_launches[route]`` and, with a window, ``window_launches``. A CPU
tensor goes to the plain version (``ref.attention``); a CUDA tensor goes to
the planned kernel or raises.

Under a gradient (grad mode on and q, k or v requiring one) the call runs
through ``FlashAttention``, an autograd Function: its forward is the same
planned kernel (or the plain version on the host), its backward recomputes
attention with the differentiable plain version in blocks of
``BACKWARD_Q_BLOCK`` query rows. The reference's Pallas kernel has no
backward kernel (no ``custom_vjp``); its training differentiates the XLA
stand-in, so this backward is the reference's, not a fallback.

Routes: ``wgmma`` (bf16 with D 64 or 128 on 16-byte-aligned tensors:
tensor cores, GQA-packed query tiles fed by a TMA ring) and ``ffma`` (f32,
and other bf16: f32 FMA on the CUDA cores, true f32 for f32 inputs).

The forward is the custom op ``torch.ops.repro_torch.flash_fwd`` (a
``torch.library`` op), so that a dispatch mode (``torch.utils.flop_counter.FlopCounterMode``, the port's
``perf.op_cost`` counter) sees the kernel as one op: its CPU
implementation is the plain version, its CUDA implementation the planned
kernel, its fake (the meta device) an empty output of q's shape, and its
flop formula counts ``4·B·H·S·T·D``, dense S x T, as the reference's
XLA program does (``blocked_attention`` computes every key block and
masks after the dot). The kernel itself skips the blocks its mask hides:
its bound counts the visible (query, key) pairs instead.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

#: kernel launches since the last reset (plain integer; callers zero it)
launches = 0
#: the same launches by route (callers zero them)
route_launches: Dict[str, int] = {"ffma": 0, "wgmma": 0}
#: the launches with a sliding window (gemma3's local layers; callers zero
#: it)
window_launches = 0

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's routes and their codes
ROUTE_CODES = {"ffma": 0, "wgmma": 1}
#: query rows a block takes on each route (packed rows on wgmma)
TILES = {"ffma": (64,), "wgmma": (64,)}
#: the head dims the wgmma route takes (bf16 only): a row of 64 or 128
#: elements is one or two 128-byte TMA boxes
WGMMA_HEAD_DIMS = (64, 128)
#: query rows the backward recomputes at a time: the reference trains with
#: ``q_block=min(512, seq)``, so [B,H,S,T] f32 scores never exist whole
BACKWARD_Q_BLOCK = 512


def plan(b: int, h: int, hkv: int, s: int, t: int, d: int,
         dtype: torch.dtype, sm_count: int,
         aligned: bool = True) -> Tuple[str, int]:
    """(route, block_m) of the kernel for q [b,h,s,d], k/v [b,hkv,t,d].

    bf16 with d in ``WGMMA_HEAD_DIMS`` and q, k, v 16-byte aligned
    (``aligned``: TMA reads from such addresses only) -> wgmma; f32, bf16
    with d 16 or 32, and unaligned bf16 -> ffma. Each route has one tile
    (``TILES``): a 128-row wgmma tile was slower than or level with the
    64-row one at every serve shape (PERF.md), so the shape and
    ``sm_count`` do not change the choice."""
    route = ("wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
             and aligned else "ffma")
    return route, TILES[route][0]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kernel_attributes(route: str, block_m: int, d: int,
                      dtype: torch.dtype) -> Dict[str, int]:
    """What the compiler gave the kernel of (route, block_m, d, dtype):
    registers and local (spill) bytes a thread, static shared bytes, the
    dynamic shared bytes a launch asks, threads a block."""
    fn = build.load("flash_attention").flash_attention_attributes
    out = (ctypes.c_int * 5)()
    rc = fn(ctypes.c_int(ROUTE_CODES[route]), ctypes.c_int(block_m),
            ctypes.c_int(d), ctypes.c_int(_DTYPES[dtype]), out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_attributes failed: "
                           f"cudaError {rc}")
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem",
                     "threads"), out))


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
    kernels keep the running max, denominator and accumulator in f32 and
    write q's dtype (the wgmma route rounds the softmax weights to bf16
    before multiplying them with v)."""
    _check(q, k, v, q_offset, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset)


def _forward(q, k, v, causal, window, q_offset):
    """The plain version on the host, the planned kernel on the card, an
    empty output on the meta device: the custom op ``flash_fwd``."""
    return torch.ops.repro_torch.flash_fwd(q, k, v, causal, window,
                                           q_offset)


# the op's library, defined once at import; its kernels are registered
# straight on the dispatcher: ``torch.library.custom_op``'s per-call
# wrappers cost ~45 us a call by CUDA events on the H100's host, more
# than the rest of a serve-shape call (~31 us)
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int? window, int q_offset) -> Tensor")


def _flash_fwd_cpu(q, k, v, causal, window, q_offset):
    """The forward on host tensors: the plain version."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def _flash_fwd_cuda(q, k, v, causal, window, q_offset):
    """The forward on CUDA tensors: the planned kernel, counted."""
    b, h, s, d = q.shape
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v))
    route, block_m = plan(b, h, k.shape[1], s, k.shape[2], d, q.dtype,
                          _sm_count(index), aligned)
    return _launch(q, k, v, causal, window, q_offset, route, block_m)


@torch.library.register_fake("repro_torch::flash_fwd", lib=_LIB)
def _flash_fwd_fake(q, k, v, causal, window, q_offset):
    """Shapes only (the meta device): launches nothing."""
    return torch.empty_like(q)


_LIB.impl("flash_fwd", _flash_fwd_cpu, "CPU")
_LIB.impl("flash_fwd", _flash_fwd_cuda, "CUDA")


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flop(q_shape, k_shape, *args, out_shape=None, **kwargs):
    """2·B·H·S·T·D for QKᵀ and as many for PV, over every (query, key)
    pair whatever the mask."""
    b, h, s, d = q_shape
    return 4 * b * h * s * k_shape[2] * d


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` under a gradient: the kernel forward, and a
    backward that recomputes the plain version (``attention_grads``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return _forward(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        return attention_grads(q, k, v, do, causal=causal, window=window,
                               q_offset=q_offset) + (None, None, None)


def attention_grads(q, k, v, do, *, causal=True, window=None, q_offset=0,
                    block=BACKWARD_Q_BLOCK):
    """(dq, dk, dv) of ``ref.attention`` at (q, k, v) against ``do``,
    recomputed ``block`` query rows at a time over the keys those rows can
    see, so that a block's scores are [B, H, block, keys] and never the
    whole [B, H, S, T]. dk and dv are summed over the blocks in f32."""
    b, h, s, d = q.shape
    t = k.shape[2]
    dq = torch.zeros_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        # the keys rows [i0, i1) can see: from the window's start of the
        # first row to the diagonal of the last
        lo = 0 if window is None else max(0, q_offset + i0 - window + 1)
        hi = min(t, q_offset + i1) if causal else t
        if hi <= lo:
            continue                    # no visible key: zero output rows
        qb, kb, vb = (x.detach().requires_grad_() for x in (
            q[:, :, i0:i1], k[:, :, lo:hi], v[:, :, lo:hi]))
        with torch.enable_grad():
            o = ref.attention(qb, kb, vb, causal=causal, window=window,
                              q_offset=q_offset + i0 - lo)
        gq, gk, gv = torch.autograd.grad(o, (qb, kb, vb), do[:, :, i0:i1])
        dq[:, :, i0:i1] = gq
        dk[:, :, lo:hi] += gk
        dv[:, :, lo:hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int], q_offset: int, route: str,
           block_m: int) -> torch.Tensor:
    """The kernel of ``route`` with ``block_m``-row tiles on CUDA tensors;
    counts the launch. ``flash_attention`` calls it with ``plan``'s
    choice; the card's tests call it with every route and tile. Raises
    ValueError for an unknown route or tile, a tensor off the card or not
    contiguous, and RuntimeError where the kernel refuses the plan (the
    wgmma route on f32, on D 16 or 32, on unaligned tensors) or the launch
    fails."""
    _check(q, k, v, q_offset, window)
    if route not in TILES or block_m not in TILES[route]:
        raise ValueError(f"flash_attention has no kernel on route {route} "
                         f"with {block_m}-row tiles")
    return _launch(q, k, v, causal, window, q_offset, route, block_m)


def _launch(q, k, v, causal, window, q_offset, route, block_m):
    """``launch`` on inputs that ``_check`` has passed."""
    global launches, window_launches
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
                       _DTYPES[q.dtype], ROUTE_CODES[route], block_m,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({route}, "
                           f"{block_m}-row tiles, {q.dtype}, D {d}): "
                           f"cudaError {rc}")
    launches += 1
    route_launches[route] += 1
    if window is not None:
        window_launches += 1
    return out

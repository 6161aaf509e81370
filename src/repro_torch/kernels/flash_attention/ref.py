"""Plain PyTorch version of the flash attention kernel: exact masked softmax
attention with f32 scores. The wrapper uses it for CPU tensors only; the
tests and ``chip_smoke.py`` hold the CUDA kernel against it."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """q: [B,H,S,D]; k, v: [B,Hkv,T,D] with ``Hkv | H`` -> [B,H,S,D].

    Query row i sits at position ``q_offset + i``, key j at position j;
    query head h reads kv head ``h // (H // Hkv)``. A row with no visible
    key gives zeros, as the kernel does."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, s, d)
    sc = torch.einsum("bgqsd,bgtd->bgqst", qf, k.float()) / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    sc = torch.where(mask, sc, torch.full((), NEG_INF, device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bgqst,bgtd->bgqsd", p, v.float()) / denom
    return o.reshape(b, h, s, d).to(q.dtype)

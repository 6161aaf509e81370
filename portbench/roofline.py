"""The table of peaks and the operation and byte counts of the kernels
whose share of their roofline the benchmark reports.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at
its full 700 W limit; the run prints the card's own limit beside every
share."""
from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def flash_cost(b: int, h: int, hkv: int, s: int, t: int, d: int,
               q_offset: int, causal: bool, window, elem_bytes: int = 2):
    """(flops, bytes) one flash forward launch needs: q [b,h,s,d] over k,
    v [b,hkv,t,d]. Query row i sits at ``q_offset + i``; under causal
    masking it sees keys ``0..q_offset+i`` (at most ``t``), and under a
    window only the last ``window`` of them. Two products of ``2·d`` flops
    a visible (query, key) pair; q, o read and written once, and k, v read
    once over the keys any row can see."""
    pairs = 0
    if causal:
        # rows see min(t, q_offset + i + 1) keys, i in [0, s)
        full_from = max(0, min(s, t - q_offset))       # rows below t
        # rows i < full_from see q_offset + i + 1 keys
        n = full_from
        pairs = n * q_offset + n * (n + 1) // 2 + (s - n) * t
        if window:
            pairs = sum(min(t, q_offset + i + 1) - max(0, q_offset + i + 1
                                                         - window)
                        for i in range(s))
        keys = min(t, q_offset + s)
    else:
        pairs, keys = s * t, t
    flops = 4 * b * h * d * pairs
    nbytes = elem_bytes * b * d * (2 * h * s + 2 * hkv * keys)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def active_params(model: Dict, n_total: float) -> float:
    """Parameters a token uses: in an MoE model, all but the routed experts
    it does not choose (``repro_torch.perf.roofline.active_params``,
    copied)."""
    if not model.get("num_experts"):
        return n_total
    routed = 3 * model["d_model"] * model["moe_d_ff"] * model["num_experts"]
    n_moe = model["num_layers"] - model.get("first_k_dense", 0)
    return n_total - routed * n_moe * (
        1 - model["experts_per_token"] / model["num_experts"])


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())

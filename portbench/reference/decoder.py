"""The plain reference of the served decoders: a float32 forward in plain
PyTorch of the dense decoder (granite-20b) and of the fine-grained MoE
decoder (deepseek-moe-16b), written from the model's equations.

It imports nothing of the program under test and takes nothing the
program made: it reads the weights the benchmark drew (``weights.py``),
the prompts the benchmark sent and the tokens the program served, and
computes every logit again. It runs one layer at a time over all the
sequences it checks, each layer's weights cast to float32 (or passed
through a lower ``Precision``) for that layer only, and attention in
blocks of query rows, so that a 28-billion-parameter model fits beside
its bf16 weights.

The block, as the program serves it (and as the system it reproduces
defines it), with its departures from the published models:

- ``x = embedding[tokens]``; per layer ``x += attn(rms(x, norm1))`` and
  ``x += ffn(rms(x, norm2))``; logits ``rms(x, final_norm) @ unembed``.
  ``rms(x, s) = x / sqrt(mean(x^2) + 1e-6) * (1 + s)``.
- Attention: ``q = h @ wq``, ``k = h @ wk``, ``v = h @ wv`` per head of
  ``head_dim``, half-split rotary embedding (``theta``) on q and k, causal
  softmax at ``1/sqrt(head_dim)``, query head ``i`` reading KV head
  ``i // (H / Hkv)``, out ``o @ wo``. (granite-20b as published is a
  GPTBigCode block: LayerNorm, learned positions and a GELU MLP; the
  system serves it as this llama-style block at the published widths.)
- Dense FFN: SwiGLU, ``(silu(h @ w_gate) * (h @ w_up)) @ w_down``.
- MoE FFN: router ``softmax(h @ router)`` over ``E`` experts in float32,
  the ``k`` largest (ties to the lower index), their weights renormalised
  to sum to 1 (the published deepseek-moe-16b leaves them unnormalised),
  each chosen expert a SwiGLU of width ``moe_d_ff``; plus the shared
  experts as one SwiGLU of width ``shared * moe_d_ff``. A leading dense
  layer's SwiGLU has width ``moe_d_ff * (shared + k)`` (published: 10944).
- Capacity (the system's, not in the published model): tokens routed in
  one group compete for ``ceil(capacity_factor * T * k / E)`` slots an
  expert, ``T`` the group's length; past that, an expert drops its
  choices in token order (token-major, a token's choices in rank order).
  A served prompt is prefilled as one group right-padded to its bucket
  (the smallest power of two from 8 up, at most ``max_seq``), the pad
  after every real token, so ``T`` is the bucket and the pad never takes
  a real token's slot. Each decoded token routes alone: its ``k``
  choices always fit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-6


# ---------------------------------------------------------------------------
# the parameter tree (names and shapes as the weights are drawn and served)


def param_shapes(m: Dict) -> Dict:
    """(shape, fan_in) of every weight of model ``m`` (a configuration's
    ``model`` section); fan_in None marks a norm scale."""
    d, h, kvh, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    first = m.get("first_k_dense", 0)
    n = m["num_layers"] - first

    def attn(pre):
        return {"wq": (pre + (d, h, dh), d), "wk": (pre + (d, kvh, dh), d),
                "wv": (pre + (d, kvh, dh), d),
                "wo": (pre + (h, dh, d), h * dh)}

    def mlp(pre, f):
        return {"w_gate": (pre + (d, f), d), "w_up": (pre + (d, f), d),
                "w_down": (pre + (f, d), f)}

    def dense(pre, f):
        return {"norm1": (pre + (d,), None), "norm2": (pre + (d,), None),
                "attn": attn(pre), "mlp": mlp(pre, f)}

    tree = {"embedding": ((m["vocab_size"], d), d),
            "unembed": ((d, m["vocab_size"]), d),
            "final_norm": ((d,), None)}
    if m.get("num_experts"):
        e, fe = m["num_experts"], m["moe_d_ff"]
        fs = m["num_shared_experts"] * fe
        tree["layers"] = {
            "norm1": ((n, d), None), "norm2": ((n, d), None),
            "attn": attn((n,)),
            "moe": {"router": ((n, d, e), d),
                    "w_gate": ((n, e, d, fe), d), "w_up": ((n, e, d, fe), d),
                    "w_down": ((n, e, fe, d), fe),
                    **({"shared": mlp((n,), fs)} if fs else {})}}
        width = fe * (m["num_shared_experts"] + m["experts_per_token"])
    else:
        tree["layers"] = dense((n,), m["d_ff"])
        width = m["d_ff"]
    if first:
        tree["dense_prefix"] = {f"layer_{i}": dense((), width)
                                for i in range(first)}
    return tree


# ---------------------------------------------------------------------------
# precisions: the reference's (float32) and the control's (fp8)


class Precision:
    """Float32: every weight cast up, every activation as it is."""

    def weight(self, w):
        return w.float()

    def act(self, x):
        return x


class Fp8(Precision):
    """The control: every matmul's inputs rounded to float8 e4m3, weights
    with a scale per output column, activations with a scale per row
    (token), then multiplied in float32. The step below the bf16 the
    configurations state."""
    MAX = 448.0

    def _round(self, x, dim):
        s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / self.MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def weight(self, w):
        return self._round(w.float(), -2)

    def act(self, x):
        return self._round(x, -1)


def _cast(tree, prec: Precision):
    """A layer's weights in ``prec``: norm scales (1-D) in float32, the
    matrices as ``prec`` rounds them, each as the matmul reads it."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _cast(v, prec)
        elif v.dim() == 1:
            out[k] = v.float()
        elif k in ("wq", "wk", "wv"):
            out[k] = prec.weight(v.reshape(v.shape[0], -1))
        elif k == "wo":
            out[k] = prec.weight(v.reshape(-1, v.shape[-1]))
        else:
            out[k] = prec.weight(v)
    return out


# ---------------------------------------------------------------------------
# the block


def rms_norm(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * (
        1.0 + scale)


def rope(x, theta):
    """Half-split rotary embedding of x [n, heads, dh] at positions 0..n-1."""
    n, dh = x.shape[0], x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(h, w, m, prec, q_block=512):
    n = h.shape[0]
    hh, kvh, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    g = hh // kvh
    hq = prec.act(h)
    q = rope((hq @ w["wq"]).view(n, hh, dh), m["rope_theta"])
    k = rope((hq @ w["wk"]).view(n, kvh, dh), m["rope_theta"])
    v = (hq @ w["wv"]).view(n, kvh, dh)
    out = torch.empty(n, kvh, g, dh, device=h.device)
    scale = 1.0 / math.sqrt(dh)
    for lo in range(0, n, q_block):
        hi = min(lo + q_block, n)
        qb = q[lo:hi].view(hi - lo, kvh, g, dh)
        s = torch.einsum("bkgd,tkd->kgbt", qb, k[:hi]) * scale
        causal = (torch.arange(hi, device=h.device)[None, :]
                  <= torch.arange(lo, hi, device=h.device)[:, None])
        s = s.masked_fill(~causal, float("-inf"))
        out[lo:hi] = torch.einsum("kgbt,tkd->bkgd", torch.softmax(s, -1),
                                  v[:hi])
    return prec.act(out.view(n, hh * dh)) @ w["wo"]


def swiglu(h, w, prec):
    hq = prec.act(h)
    return prec.act(F.silu(hq @ w["w_gate"]) * (hq @ w["w_up"])) \
        @ w["w_down"]


def bucket(n: int, max_seq: int) -> int:
    """The padded length a prompt of ``n`` tokens is prefilled at."""
    b = 8
    while b < n:
        b *= 2
    return min(b, max_seq)


def capacity(m: Dict, tokens: int) -> int:
    return max(int(math.ceil(m["capacity_factor"] * tokens
                             * m["experts_per_token"] / m["num_experts"])), 1)


def kept_choices(ids, n_group: int, cap: int):
    """[n, k] bool: which choices of ``ids`` [n, k] an expert keeps, the
    first ``n_group`` tokens routed as one group of ``cap`` slots an
    expert and each later token alone."""
    n, k = ids.shape
    keep = torch.ones_like(ids, dtype=torch.bool)
    flat = ids[:n_group].reshape(-1)
    if flat.numel():
        order = torch.sort(flat, stable=True).indices
        sorted_ids = flat[order]
        start = torch.searchsorted(sorted_ids, sorted_ids, side="left")
        rank = torch.empty_like(flat)
        rank[order] = torch.arange(flat.numel(), device=ids.device) - start
        keep[:n_group] = (rank < cap).view(n_group, k)
    return keep


def moe(h, w, m, prec, n_group: int, cap: int, stats: Dict):
    e, k = m["num_experts"], m["experts_per_token"]
    hq = prec.act(h)
    probs = torch.softmax(hq @ w["router"], dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    weights = vals / vals.sum(-1, keepdim=True)
    keep = kept_choices(ids, n_group, cap)
    stats["dropped"] = stats.get("dropped", 0) + int((~keep).sum())
    stats["choices"] = stats.get("choices", 0) + keep.numel()
    y = torch.zeros_like(h)
    for ex in range(e):
        tok, j = torch.nonzero((ids == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = hq[tok]
        he = prec.act(F.silu(xe @ w["w_gate"][ex]) * (xe @ w["w_up"][ex]))
        y.index_add_(0, tok, (he @ w["w_down"][ex]) * weights[tok, j, None])
    if "shared" in w:
        y = y + swiglu(h, w["shared"], prec)
    return y


def _layers(weights: Dict, m: Dict):
    """(weights of one layer, is_moe) for every layer, in order."""
    for name in sorted(weights.get("dense_prefix", {}),
                       key=lambda s: int(s.split("_")[1])):
        yield weights["dense_prefix"][name], False
    stack = weights["layers"]
    n = m["num_layers"] - m.get("first_k_dense", 0)

    def at(tree, i):
        return {k: at(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    for i in range(n):
        yield at(stack, i), bool(m.get("num_experts"))


@torch.no_grad()
def logits_at(weights: Dict, m: Dict, seqs: Sequence, prec: Precision,
              max_seq: int, stats: Dict = None) -> List[torch.Tensor]:
    """For each ``(tokens, n_prompt, rows)`` of ``seqs`` (tokens a 1-D
    int64 tensor on the weights' device, the first ``n_prompt`` of them
    the prompt), the logits [len(rows), vocab] at positions ``rows``, in
    float32. ``stats`` gets the MoE layers' dropped and total choices."""
    stats = {} if stats is None else stats
    xs = [weights["embedding"][t].float() for t, _, _ in seqs]
    for lw, is_moe in _layers(weights, m):
        w = _cast(lw, prec)
        for i, (_, n_prompt, _) in enumerate(seqs):
            x = xs[i]
            x = x + attention(rms_norm(x, w["norm1"]), w["attn"], m, prec)
            hn = rms_norm(x, w["norm2"])
            if is_moe:
                cap = capacity(m, bucket(n_prompt, max_seq))
                x = x + moe(hn, w["moe"], m, prec, n_prompt, cap, stats)
            else:
                x = x + swiglu(hn, w["mlp"], prec)
            xs[i] = x
        del w
    unembed = prec.weight(weights["unembed"])
    norm = weights["final_norm"].float()
    return [prec.act(rms_norm(x[rows], norm)) @ unembed
            for x, (_, _, rows) in zip(xs, seqs)]

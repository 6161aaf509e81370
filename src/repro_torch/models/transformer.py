"""Dense decoder-only transformer.

Covers granite-20b, deepseek-coder-33b and qwen3-32b (qk_norm), whose
caches are flat ``[L, B, T, kvh, dh]`` stacks, and gemma3-27b, whose 5:1
local:global layers keep ``{"global": (k, v), "local": (k, v)}`` caches:
full-length stacks for the global layers and window-sized rings for the
local ones. The parameter dict keeps the reference's stacked ``[L, ...]``
layout and names (``layers/attn/wq [L, d, h, dh]``, ...), so the weight
bridge is a plain map; a Python loop over layers takes the place of
``lax.scan`` (and of ``lax.cond`` between a global and a local layer).

Training: ``init(dtype=torch.float32)`` makes the f32 master parameters
(the reference's ``param_dtype``); the layers cast each weight to the
compute dtype where they use it, so gradients land on the f32 leaves.
``hidden``/``forward`` run the stack without caches, each layer under
``torch.utils.checkpoint`` when a gradient is being taken (``remat``, on by
default as in the reference, whose scan body is
``jax.checkpoint(nothing_saveable)``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import common


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree as (shape, fan_in) leaves; fan_in None marks a
    zero-initialised norm scale."""
    L, d, h, kvh, dh, f = (cfg.num_layers, cfg.d_model, cfg.q_heads,
                           cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)
    return {
        "embedding": ((cfg.vocab_size, d), d),
        "unembed": ((d, cfg.vocab_size), d),
        "final_norm": ((d,), None),
        "layers": {
            "norm1": ((L, d), None),
            "norm2": ((L, d), None),
            "attn": {
                "wq": ((L, d, h, dh), d),
                "wk": ((L, d, kvh, dh), d),
                "wv": ((L, d, kvh, dh), d),
                "wo": ((L, h, dh, d), h * dh),
                **({"q_norm": ((L, dh), None), "k_norm": ((L, dh), None)}
                   if cfg.qk_norm else {}),
            },
            "mlp": {
                "w_gate": ((L, d, f), d),
                "w_up": ((L, d, f), d),
                "w_down": ((L, f, d), f),
            },
        },
    }


def layer_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer is_global flag (gemma3's local:global pattern: every
    ``local_global_period``-th layer is global)."""
    if cfg.local_global_period <= 0:
        return np.ones((cfg.num_layers,), np.bool_)
    idx = np.arange(cfg.num_layers)
    return (idx + 1) % cfg.local_global_period == 0


class DecoderLM:
    """Functional decoder-only LM over an explicit parameter dict."""

    def __init__(self, cfg: ModelConfig, remat: bool = True):
        if cfg.family != "dense" or cfg.pad_q_heads or cfg.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: the port's DecoderLM serves the dense "
                "families only (no MoE or head padding yet)")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.remat = remat

    # -- params ------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights N(0, 1/fan_in) on ``device``, filled layer by
        layer in place (no f32 copy of a bf16 model), from ``generator`` (a
        ``torch.Generator`` on that device). ``dtype`` None gives
        ``cfg.dtype`` (serving); training passes the master dtype,
        ``torch.float32``."""
        dev = resolve_device(device)
        dtype = self.dtype if dtype is None else dtype

        def make(spec):
            if isinstance(spec, dict):
                return {k: make(v) for k, v in spec.items()}
            shape, fan_in = spec
            t = torch.zeros(shape, dtype=dtype, device=dev)
            if fan_in is not None:
                std = 1.0 / max(fan_in, 1) ** 0.5
                for row in (t if len(shape) > 2 else (t,)):
                    row.normal_(0.0, std, generator=generator)
            return t

        return make(param_shapes(self.cfg))

    # -- forward -----------------------------------------------------------

    def _run_stack(self, x, params, *, positions, caches=None,
                   cache_pos=None, true_len=None):
        """Run the layer stack; caches (a flat (k_all, v_all)
        [L,B,T,kvh,dh] pair, or gemma3's dict of global stacks and local
        rings) are written in place, layer by layer."""
        if isinstance(caches, dict):
            return self._run_stack_windowed(
                x, params, positions=positions, caches=caches,
                cache_pos=cache_pos, true_len=true_len)
        cfg = self.cfg
        rope_cs = common.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        lp = params["layers"]
        flags = layer_flags(cfg)
        remat = caches is None and self.remat and torch.is_grad_enabled()
        for i, p in enumerate(_layers_of(lp, cfg.num_layers)):
            c = None if caches is None else (caches[0][i], caches[1][i])
            layer = functools.partial(
                self._layer, positions=positions, is_global=bool(flags[i]),
                rope_cs=rope_cs, kv_cache=c, cache_pos=cache_pos)
            if remat:
                x = checkpoint(layer, x, p, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, p)
        return x, caches

    def _layer(self, x, p, **attn):
        """One layer: attention and the MLP, each around its residual."""
        h, _ = common.attention(common.rms_norm(x, p["norm1"]), p["attn"],
                                self.cfg, **attn)
        return self._mlp_block(x + h, p)

    def _mlp_block(self, x, p):
        """The residual MLP half of a layer."""
        return x + common.mlp(common.rms_norm(x, p["norm2"]), p["mlp"])

    # -- gemma3-style local:global window caches -----------------------------

    def _ring_gather(self, k, v, s, w):
        """Last-``w``-tokens ring from fresh K/V [B,S,kvh,dh] of true length
        ``s``: slot j holds the most recent position p with p ≡ j (mod w),
        zeros where no such position exists yet."""
        j = torch.arange(w, device=k.device)
        p = (s - 1) - ((s - 1 - j) % w)
        pc = p.clamp_min(0)
        keep = (p >= 0)[None, :, None, None]
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        return (torch.where(keep, k.index_select(1, pc), zero),
                torch.where(keep, v.index_select(1, pc), zero))

    def window_size(self):
        return max(self.cfg.sliding_window, 1)

    def _run_stack_windowed(self, x, params, *, positions, caches, cache_pos,
                            true_len=None):
        """The layer loop over local:global caches: global layers attend
        over their full-length cache stack (flash, causal, on prefill),
        local layers over the last ``w`` positions — a prefill on the flash
        kernel's window mode with the fresh keys and values then gathered
        into the ring, a decode over the ring's slots at the positions they
        hold. ``true_len`` builds the rings from the true last token of a
        right-padded prompt, not its pad tail."""
        cfg = self.cfg
        gk, gv = caches["global"]
        lk, lv = caches["local"]
        w = lk.shape[2]
        s = x.shape[1]
        rope_cs = common.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        lp = params["layers"]
        if s == 1:
            # each slot j of the ring holds position cp - ((cp - j) % w);
            # negative where the row has not reached it yet
            j = torch.arange(w, device=x.device)
            if isinstance(cache_pos, torch.Tensor):
                cp = cache_pos.long()[:, None]                    # [B, 1]
                k_pos = cp - ((cp - j[None, :]) % w)              # [B, w]
                slot = cache_pos.long() % w
            else:
                k_pos = cache_pos - ((cache_pos - j) % w)         # [w]
                slot = int(cache_pos) % w
        lig = lil = 0
        for i, is_global in enumerate(layer_flags(cfg)):
            p = _layer_of(lp, i)
            y = common.rms_norm(x, p["norm1"])
            if is_global:
                h, _ = common.attention(
                    y, p["attn"], cfg, positions=positions, is_global=True,
                    rope_cs=rope_cs, kv_cache=(gk[lig], gv[lig]),
                    cache_pos=cache_pos)
                lig += 1
            elif s == 1:
                h, _ = common.attention(
                    y, p["attn"], cfg, positions=positions, is_global=False,
                    rope_cs=rope_cs, kv_cache=(lk[lil], lv[lil]),
                    cache_pos=cache_pos, cache_slot=slot, k_positions=k_pos,
                    k_valid=k_pos >= 0)
                lil += 1
            else:
                h, (fk, fv) = common.attention(
                    y, p["attn"], cfg, positions=positions, is_global=False,
                    rope_cs=rope_cs, return_kv=True)
                rk, rv = self._ring_gather(
                    fk.to(lk.dtype), fv.to(lv.dtype),
                    s if true_len is None else int(true_len), w)
                lk[lil] = rk
                lv[lil] = rv
                lil += 1
            x = self._mlp_block(x + h, p)
        return x, caches

    def _inputs_to_h(self, batch, params):
        return common.embed(batch["tokens"], params, self.dtype)

    def hidden(self, params, batch):
        """Final hidden states (pre-unembed) and the aux loss (0.0 for the
        dense family): the chunked cross-entropy's input, which never
        materializes the [B,S,V] logits."""
        x = self._inputs_to_h(batch, params)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_stack(x, params, positions=positions)
        return x, 0.0

    def forward(self, params, batch):
        """Training/scoring forward: batch = {tokens [B,S]} ->
        (logits [B,S,V], aux)."""
        x, aux = self.hidden(params, batch)
        return common.unembed(x, params), aux

    # -- serving -----------------------------------------------------------

    def cache_shapes(self, batch_size: int, max_seq: int):
        """The shapes of ``init_cache``'s tree: a flat (k, v) pair of
        [L, B, max_seq, kvh, dh], or with local:global layers
        ``{"global": (k, v), "local": (k, v)}`` with rings of
        ``min(window, max_seq)`` slots."""
        cfg = self.cfg
        tail = (cfg.num_kv_heads, cfg.head_dim)
        if cfg.local_global_period > 0:
            n_global = int(layer_flags(cfg).sum())
            w = min(self.window_size(), max_seq)
            g = (n_global, batch_size, max_seq) + tail
            loc = (cfg.num_layers - n_global, batch_size, w) + tail
            return {"global": (g, g), "local": (loc, loc)}
        shape = (cfg.num_layers, batch_size, max_seq) + tail
        return (shape, shape)

    def init_cache(self, batch_size, max_seq, dtype=torch.bfloat16,
                   device: DeviceLike = None):
        dev = resolve_device(device)

        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return tuple(torch.zeros(s, dtype=dtype, device=dev)
                         for s in tree)

        return zeros(self.cache_shapes(batch_size, max_seq))

    def prefill(self, params, batch, caches, true_len: Optional[int] = None,
                start_pos: Optional[int] = None):
        """Write KV caches at [start, start+S) in place; returns
        (logits of the last true token [B,1,V], caches).

        ``true_len``: true prompt length of a right-padded (bucketed) chunk;
        logits come from position ``true_len - 1`` and window rings are
        built from it. ``start_pos``: the chunk's absolute offset
        (prefix-cache tail prefill) — token i sits at ``start_pos + i`` and
        attends causally over the cache prefix [0, start_pos) plus itself;
        a ring cannot resume mid-stream, so it is flat caches only."""
        if start_pos is not None and isinstance(caches, dict):
            raise ValueError("chunked prefill (start_pos) is not supported "
                             "for local:global window ring caches")
        x = self._inputs_to_h(batch, params)
        offset = 0 if start_pos is None else int(start_pos)
        positions = torch.arange(x.shape[1], device=x.device) + offset
        x, caches = self._run_stack(x, params, positions=positions,
                                    caches=caches, cache_pos=offset,
                                    true_len=true_len)
        if true_len is None:
            last = x[:, -1:]
        else:
            t = min(max(int(true_len), 1), x.shape[1])
            last = x[:, t - 1:t]
        return common.unembed(last, params), caches

    def decode_step(self, params, token, pos, caches):
        """One decode step. token: [B,1] int; pos: a Python int or a [B]
        int tensor (each row decodes at its own position)."""
        x = common.embed(token, params, self.dtype)
        if isinstance(pos, torch.Tensor):
            positions = pos.long()[:, None]                    # [B, 1]
        else:
            positions = torch.full((1,), int(pos), device=x.device)
        x, caches = self._run_stack(x, params, positions=positions,
                                    caches=caches, cache_pos=pos)
        return common.unembed(x, params), caches


def _layer_of(v, i):
    """Layer ``i``'s slice of a stacked ``[L, ...]`` parameter tree."""
    if isinstance(v, dict):
        return {k: _layer_of(u, i) for k, u in v.items()}
    return v[i]


def _layers_of(v, n):
    """Every layer's slice of a stacked ``[L, ...]`` tree at once
    (``unbind``). Under a gradient the slices' gradients are then stacked
    once per leaf; indexing layer by layer would scatter each into a
    zero-filled copy of the whole stack and sum the copies: L full-size
    fills and L - 1 full-size sums per leaf."""
    if isinstance(v, dict):
        per = {k: _layers_of(u, n) for k, u in v.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return v.unbind(0)

"""Dense decoder-only transformer (flat-cache path).

Covers the dense families whose caches are flat ``[L, B, T, kvh, dh]``
stacks (granite-20b). The parameter dict keeps the reference's stacked
``[L, ...]`` layout and names (``layers/attn/wq [L, d, h, dh]``, ...), so
the weight bridge is a plain map; a Python loop over layers takes the
place of ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

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
            },
            "mlp": {
                "w_gate": ((L, d, f), d),
                "w_up": ((L, d, f), d),
                "w_down": ((L, f, d), f),
            },
        },
    }


class DecoderLM:
    """Functional decoder-only LM over an explicit parameter dict."""

    def __init__(self, cfg: ModelConfig):
        if (cfg.family != "dense" or cfg.local_global_period > 0
                or cfg.qk_norm or cfg.pad_q_heads or cfg.is_moe):
            raise NotImplementedError(
                f"{cfg.name}: the port's DecoderLM serves the flat-cache "
                "dense path only (no MoE, qk_norm, head padding or "
                "local:global window rings yet)")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)

    # -- params ------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict:
        """Random weights N(0, 1/fan_in) in ``cfg.dtype`` on ``device``,
        filled layer by layer in place (no f32 copy of a bf16 model), from
        ``generator`` (a ``torch.Generator`` on that device)."""
        dev = resolve_device(device)

        def make(spec):
            if isinstance(spec, dict):
                return {k: make(v) for k, v in spec.items()}
            shape, fan_in = spec
            t = torch.zeros(shape, dtype=self.dtype, device=dev)
            if fan_in is not None:
                std = 1.0 / max(fan_in, 1) ** 0.5
                for row in (t if len(shape) > 2 else (t,)):
                    row.normal_(0.0, std, generator=generator)
            return t

        return make(param_shapes(self.cfg))

    # -- forward -----------------------------------------------------------

    def _block(self, x, p, *, positions, rope_cs, cache=None, cache_pos=None):
        cfg = self.cfg
        h, _ = common.attention(
            common.rms_norm(x, p["norm1"]), p["attn"], cfg,
            positions=positions, rope_cs=rope_cs, kv_cache=cache,
            cache_pos=cache_pos)
        x = x + h
        return x + common.mlp(common.rms_norm(x, p["norm2"]), p["mlp"])

    def _run_stack(self, x, params, *, positions, caches=None,
                   cache_pos=None):
        """Run the layer stack; ``caches`` (k_all, v_all) [L,B,T,kvh,dh]
        are written in place, layer by layer."""
        cfg = self.cfg
        rope_cs = common.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        lp = params["layers"]
        for i in range(cfg.num_layers):
            c = None if caches is None else (caches[0][i], caches[1][i])
            x = self._block(x, _layer_of(lp, i), positions=positions,
                            rope_cs=rope_cs, cache=c, cache_pos=cache_pos)
        return x, caches

    def _inputs_to_h(self, batch, params):
        return common.embed(batch["tokens"], params, self.dtype)

    def forward(self, params, batch):
        """Scoring forward: batch = {tokens [B,S]} -> (logits [B,S,V], aux)."""
        x = self._inputs_to_h(batch, params)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_stack(x, params, positions=positions)
        return common.unembed(x, params), 0.0

    # -- serving -----------------------------------------------------------

    def cache_shape(self, batch_size: int, max_seq: int):
        cfg = self.cfg
        return (cfg.num_layers, batch_size, max_seq, cfg.num_kv_heads,
                cfg.head_dim)

    def init_cache(self, batch_size, max_seq, dtype=torch.bfloat16,
                   device: DeviceLike = None):
        dev = resolve_device(device)
        shape = self.cache_shape(batch_size, max_seq)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def prefill(self, params, batch, caches, true_len: Optional[int] = None,
                start_pos: Optional[int] = None):
        """Write KV caches at [start, start+S) in place; returns
        (logits of the last true token [B,1,V], caches).

        ``true_len``: true prompt length of a right-padded (bucketed) chunk;
        logits come from position ``true_len - 1``. ``start_pos``: the
        chunk's absolute offset (prefix-cache tail prefill) — token i sits
        at ``start_pos + i`` and attends causally over the cache prefix
        [0, start_pos) plus itself."""
        x = self._inputs_to_h(batch, params)
        offset = 0 if start_pos is None else int(start_pos)
        positions = torch.arange(x.shape[1], device=x.device) + offset
        x, caches = self._run_stack(x, params, positions=positions,
                                    caches=caches, cache_pos=offset)
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

"""Whisper-style encoder-decoder backbone [arXiv:2212.04356] — the
reference's ``models/whisper.py`` on tensors.

The conv/mel frontend is a stub, as in the reference: requests carry
precomputed frame embeddings [B, enc_seq, D]. Positions are sinusoidal in
the encoder and the decoder, and no layer rotates q and k. The encoder's
self-attention is non-causal and the decoder's causal; both run on the
flash kernel (the encoder over its ``enc_seq`` frames, the decoder's
prefill from the chunk's start over the whole cache row). Cross attention
is plain tensor ops, as it is plain XLA in the reference.

Serving caches (``init_cache``): ``self`` (k, v) of [L, B, max_seq, kvh,
dh] and ``cross`` (k, v) of [L, B, enc_seq, H, dh], both in ``dtype``;
``prefill`` fills ``cross`` from the frames of a request's first chunk and
writes both in place.

Under a gradient each encoder and decoder layer runs inside
``torch.utils.checkpoint``, as the reference remats them
(``jax.checkpoint(nothing_saveable)``), and gathers a rank's blocks of its
leaves there (``Sharder.use``): a rank holds one layer's gathered weights
at a time. The cross keys' and values' weights are gathered for
``build_cross_cache``, outside the layers, as the reference projects them
outside its remat: they stay live until the backward (two [D, H*dh]
leaves a decoder layer).

On a rank's blocks (``Sharder.rank_blocks``: the sharded train and serve
steps) each layer computes its share over the ``model`` ranks
(``Sharder.tp``): the MLPs split their width (3072 / 16 = 192 columns a
rank), and the self and cross attention their heads where the heads divide
over the ranks; at model 16 whisper-small's 12 heads do not (they are not
padded: ``ModelConfig.adapt_for_mesh``), so every rank runs all of them,
and the self-attention caches split over sequence instead
(``Sharder.cache_kv_split``, ``common.attention``'s ``kv_split``). The
vocabulary splits where it divides (not 51865 over 16).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.parallel.sharding import Sharder

#: the logical axes whose ``model`` split the layers' compute consumes
TP_AXES = ("heads", "kv_heads", "mlp", "vocab")


def sinusoid(positions, d_model, dtype):
    """Sinusoidal embeddings for int positions of any shape: [...] ->
    [..., D]."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def cross_kv(enc_out, p):
    """Cross-attention keys and values [B, enc_seq, H, dh] of one layer."""
    return common._proj(enc_out, p["wk"]), common._proj(enc_out, p["wv"])


def cross_attention(x, p, k, v, cfg: ModelConfig, tp=None):
    """Unmasked attention of x [B,S,d] over the encoder's k, v [B,T,H,dh],
    scores and softmax in f32. Under ``tp`` with the heads split, the
    rank's heads (of ``wq``, the cross cache and ``wo``), summed over the
    ranks."""
    b, s, _ = x.shape
    q = common._proj(x, p["wq"])
    h, dh = q.shape[-2:]
    sc = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(dh)
    pr = torch.softmax(sc, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", pr, v)
    out = common._proj(o.reshape(b, s, h * dh),
                       p["wo"].reshape(h * dh, cfg.d_model))
    if tp is not None and tp.splits(h, cfg.q_heads):
        out = tp.sum(out)
    return out


def param_shapes(cfg: ModelConfig) -> Dict:
    """The reference init's tree as (shape, fan_in) leaves."""
    d, h, dh = cfg.d_model, cfg.q_heads, cfg.head_dim
    le, ld = (cfg.enc_layers,), (cfg.num_layers,)
    tree = common.embed_shapes(cfg)
    tree["encoder"] = {
        "norm1": (le + (d,), None),
        "norm2": (le + (d,), None),
        "attn": common.attn_shapes(cfg, le),
        "mlp": common.mlp_shapes(d, cfg.d_ff, le),
    }
    tree["enc_final_norm"] = ((d,), None)
    tree["decoder"] = {
        "norm1": (ld + (d,), None),
        "norm_x": (ld + (d,), None),
        "norm2": (ld + (d,), None),
        "self_attn": common.attn_shapes(cfg, ld),
        "cross_attn": {
            "wq": (ld + (d, h, dh), d),
            "wk": (ld + (d, h, dh), d),
            "wv": (ld + (d, h, dh), d),
            "wo": (ld + (h, dh, d), h * dh),
        },
        "mlp": common.mlp_shapes(d, cfg.d_ff, ld),
    }
    return tree


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``param_shapes``' leaves, tree for tree."""
    pax = ("layers",)
    norm = pax + ("norm",)
    tree = common.embed_axes()
    tree["encoder"] = {"norm1": norm, "norm2": norm,
                       "attn": common.attn_axes(cfg, pax),
                       "mlp": common.mlp_axes(pax)}
    tree["enc_final_norm"] = ("norm",)
    tree["decoder"] = {
        "norm1": norm, "norm_x": norm, "norm2": norm,
        "self_attn": common.attn_axes(cfg, pax),
        "cross_attn": {"wq": pax + ("embed", "heads", "head_dim"),
                       "wk": pax + ("embed", "heads", "head_dim"),
                       "wv": pax + ("embed", "heads", "head_dim"),
                       "wo": pax + ("heads", "head_dim", "embed")},
        "mlp": common.mlp_axes(pax),
    }
    return tree


def _remat(layer, x, *args):
    """``layer(x, *args)``; under a gradient inside a checkpoint, so that
    its backward recomputes it (and gathers its weights again)."""
    if not torch.is_grad_enabled():
        return layer(x, *args)
    return checkpoint(layer, x, *args, use_reentrant=False,
                      preserve_rng_state=False)


class Whisper:
    """Functional encoder-decoder over an explicit parameter dict."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, shd_rules=None):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.shd = Sharder(mesh, rules=shd_rules, tp_axes=TP_AXES)

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights N(0, 1/fan_in) on ``device`` from ``generator``;
        ``dtype`` None gives ``cfg.dtype``."""
        return common.init_tree(param_shapes(self.cfg), generator,
                                resolve_device(device),
                                self.dtype if dtype is None else dtype)

    def param_axes(self) -> Dict:
        return param_axes(self.cfg)

    # -- encoder -------------------------------------------------------------

    def encode(self, params, frames):
        """frames: [B, enc_seq, D] precomputed embeddings (stub frontend);
        non-causal self-attention without RoPE."""
        cfg = self.cfg
        x = frames.to(self.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoid(positions, cfg.d_model, self.dtype)[None]
        for p in common.layers_of(params["encoder"], cfg.enc_layers):
            x = _remat(self._enc_layer, x, p, positions)
        return common.rms_norm(x, self.shd.use(params["enc_final_norm"],
                                               "enc_final_norm"))

    def _enc_layer(self, x, p, positions):
        """One encoder layer on its slice ``p`` of the stacked leaves."""
        p = self.shd.use(p, "encoder", stacked=True)
        tp = self.shd.tp
        h, _ = common.attention(
            common.rms_norm(x, p["norm1"]), p["attn"], self.cfg,
            positions=positions, causal=False, use_rope=False, tp=tp)
        x = x + h
        return x + common.mlp(common.rms_norm(x, p["norm2"]), p["mlp"], tp,
                              self.cfg.d_ff)

    # -- decoder -------------------------------------------------------------

    def _decoder_stack(self, x, params, *, positions, cross_cache,
                       caches=None, cache_pos=None):
        xk_all, xv_all = cross_cache
        layers = common.layers_of(params["decoder"], self.cfg.num_layers)
        split = None if caches is None else self.shd.cache_kv_split("self")
        tp = self.shd.tp
        for i, p in enumerate(layers):
            # the cross keys and values come from the cross cache: the
            # layer gathers what it runs
            p = dict(p, cross_attn={k: p["cross_attn"][k]
                                    for k in ("wq", "wo")})
            if caches is None:
                x = _remat(self._dec_layer, x, p, xk_all[i], xv_all[i],
                           positions, None, None, None, tp)
            else:
                x = self._dec_layer(x, p, xk_all[i], xv_all[i], positions,
                                    (caches[0][i], caches[1][i]), cache_pos,
                                    split, tp)
        return x

    def _dec_layer(self, x, p, xk, xv, positions, cache=None,
                   cache_pos=None, kv_split=None, tp=None):
        """One decoder layer on its slice ``p`` of the stacked leaves, its
        cross keys and values ``xk``, ``xv`` and its self-attention
        ``cache`` (written in place; ``kv_split``: the ranks its sequence
        is split over), its compute split over ``tp``'s ranks."""
        cfg = self.cfg
        p = self.shd.use(p, "decoder", stacked=True)
        h, _ = common.attention(
            common.rms_norm(x, p["norm1"]), p["self_attn"], cfg,
            positions=positions, use_rope=False, kv_cache=cache,
            cache_pos=cache_pos, tp=tp, kv_split=kv_split)
        x = x + h
        x = x + cross_attention(common.rms_norm(x, p["norm_x"]),
                                p["cross_attn"], xk, xv, cfg, tp)
        return x + common.mlp(common.rms_norm(x, p["norm2"]), p["mlp"], tp,
                              cfg.d_ff)

    def _embed_dec(self, params, tokens, positions):
        """Token embeddings plus sinusoids of ``positions`` ([S] shared by
        the batch, or [B, S] per row)."""
        shd = self.shd
        x = common.embed(tokens, shd.leaves(params, "embedding"),
                         self.dtype, shd.tp, self.cfg.vocab_size)
        pe = sinusoid(positions, self.cfg.d_model, self.dtype)
        return x + (pe[None] if positions.dim() == 1 else pe)

    def build_cross_cache(self, params, enc_out):
        """Per-layer cross K/V: two [L, B, enc_seq, H, dh] stacks."""
        kv = [cross_kv(enc_out, self.shd.use(
            {k: p[k] for k in ("wk", "wv")}, "decoder", "cross_attn",
            stacked=True)) for p in common.layers_of(
                params["decoder"]["cross_attn"], self.cfg.num_layers)]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    def forward(self, params, batch):
        """batch: {frames [B,enc_seq,D], tokens [B,S]} -> (logits, 0.0)."""
        enc_out = self.encode(params, batch["frames"])
        cross_cache = self.build_cross_cache(params, enc_out)
        positions = torch.arange(batch["tokens"].shape[1],
                                 device=enc_out.device)
        x = self._embed_dec(params, batch["tokens"], positions)
        x = self._decoder_stack(x, params, positions=positions,
                                cross_cache=cross_cache)
        return common.unembed(x, self.shd.leaves(params, "final_norm",
                                                 "unembed")), 0.0

    def init_cache(self, batch_size, max_seq, dtype=torch.bfloat16,
                   device: DeviceLike = None):
        cfg = self.cfg
        dev = resolve_device(device)
        self_shape = (cfg.num_layers, batch_size, max_seq, cfg.num_kv_heads,
                      cfg.head_dim)
        cross_shape = (cfg.num_layers, batch_size, cfg.enc_seq, cfg.q_heads,
                       cfg.head_dim)
        return {name: tuple(torch.zeros(shape, dtype=dtype, device=dev)
                            for _ in range(2))
                for name, shape in (("self", self_shape),
                                    ("cross", cross_shape))}

    def cache_axes(self):
        """The logical axes of ``init_cache``'s leaves."""
        ax_self = ("layers", "batch", "kv_seq", "act_kv_heads", None)
        ax_cross = ("layers", "batch", None, "act_heads", None)
        return {"self": (ax_self, ax_self), "cross": (ax_cross, ax_cross)}

    def _cross(self, caches):
        return tuple(c.to(self.dtype) for c in caches["cross"])

    def prefill(self, params, batch, caches, start_pos=None):
        """Prefill decoder tokens at absolute positions [start, start+S),
        in place. ``batch["frames"]`` is required on the first chunk (it
        encodes the audio and fills ``caches["cross"]``); later chunks omit
        it and reuse the carried cross cache, so a long prompt can be fed
        in pow2 chunks without encoding again. Returns (logits of the last
        token [B,1,V], caches)."""
        if batch.get("frames") is not None:
            enc_out = self.encode(params, batch["frames"])
            for dst, src in zip(caches["cross"],
                                self.build_cross_cache(params, enc_out)):
                dst.copy_(src)
        offset = 0 if start_pos is None else int(start_pos)
        positions = torch.arange(batch["tokens"].shape[1],
                                 device=caches["self"][0].device) + offset
        x = self._embed_dec(params, batch["tokens"], positions)
        x = self._decoder_stack(x, params, positions=positions,
                                cross_cache=self._cross(caches),
                                caches=caches["self"], cache_pos=offset)
        return common.unembed(x[:, -1:], self.shd.leaves(
            params, "final_norm", "unembed")), caches

    def decode_step(self, params, token, pos, caches):
        """One decode step. pos: a Python int or a [B] int tensor (each row
        decodes at its own position)."""
        if isinstance(pos, torch.Tensor):
            positions = pos.long()[:, None]                # [B, 1]
        else:
            positions = torch.full((1,), int(pos), device=token.device)
        x = self._embed_dec(params, token, positions)
        x = self._decoder_stack(x, params, positions=positions,
                                cross_cache=self._cross(caches),
                                caches=caches["self"], cache_pos=pos)
        return common.unembed(x, self.shd.leaves(params, "final_norm",
                                                 "unembed")), caches

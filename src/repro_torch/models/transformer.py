"""Decoder-only transformer: the dense, MoE and VLM families.

Covers granite-20b, deepseek-coder-33b and qwen3-32b (qk_norm), whose
caches are flat ``[L, B, T, kvh, dh]`` stacks; gemma3-27b, whose 5:1
local:global layers keep ``{"global": (k, v), "local": (k, v)}`` caches:
full-length stacks for the global layers and window-sized rings for the
local ones; deepseek-moe-16b and moonshot-v1-16b-a3b, whose first
``first_k_dense`` layers are dense (``dense_prefix/layer_{i}``, unstacked,
MLP width ``moe_d_ff * (shared + k)``) and the rest MoE
(``layers/moe/...``, ``repro_torch.models.moe``); and the internvl2-76b
backbone, whose ``patch_proj`` maps precomputed patch embeddings into a
prefix of the sequence (``forward``/``hidden``; serving is text only, as
in the reference). ``pad_q_heads`` (``ModelConfig.adapt_for_mesh``) adds
query heads whose ``wq`` rows and ``wo`` columns are zero: exact no-ops.
The parameter dict keeps the reference's stacked ``[L, ...]`` layout and
names (``layers/attn/wq [L, d, h, dh]``, ...), so the weight bridge is a
plain map; a Python loop over layers takes the place of ``lax.scan`` (and
of ``lax.cond`` between a global and a local layer).

Training: ``init(dtype=torch.float32)`` makes the f32 master parameters
(the reference's ``param_dtype``); the layers cast each weight to the
compute dtype where they use it, so gradients land on the f32 leaves.
``hidden``/``forward`` run the stack without caches, each layer under
``torch.utils.checkpoint`` when a gradient is being taken (``remat``, on by
default as in the reference, whose scan body is
``jax.checkpoint(nothing_saveable)``), and return the MoE layers' summed
aux loss (the dense prefix's is dropped, as in the reference).

On a rank's blocks (``Sharder.rank_blocks``, the sharded train step) each
layer gathers its own leaves inside its checkpointed function
(``Sharder.use``), so the backward's recompute gathers them again and a
rank holds one layer at a time; the layer computes its share of the
heads and the MLP width (and the embedding and the logits their share of
the vocabulary) over the ``model`` ranks (``common``'s ``tp``). The MoE
router runs whole; the routed experts split over ``model`` (their
partial combines summed, or, under expert parallelism, all-to-all).
Serving runs the same way (``serve.step.ShardedServeStep``): each layer
gathers its leaves where it runs, outside any checkpoint, the logits are
the rank's block of the vocabulary, and the caches are the rank's blocks,
split over KV heads or, where the cache specs put ``kv_seq`` on a mesh
axis, over sequence (``Sharder.cache_kv_split``; ``common.attention``'s
``kv_split``).
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
from repro_torch.models import moe as moe_mod
from repro_torch.parallel.sharding import Sharder

#: the logical axes whose ``model`` split the layers' compute consumes
TP_AXES = ("heads", "kv_heads", "mlp", "vocab", "experts")


def _dense_layer_shapes(cfg: ModelConfig, pre: tuple, f: int) -> Dict:
    d = cfg.d_model
    return {
        "norm1": (pre + (d,), None),
        "norm2": (pre + (d,), None),
        "attn": common.attn_shapes(cfg, pre),
        "mlp": common.mlp_shapes(d, f, pre),
    }


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree as (shape, fan_in) leaves; fan_in None marks a
    zero-initialised norm scale. ``layers`` stacks the ``num_layers -
    first_k_dense`` scanned layers (MoE ones with ``cfg.is_moe``);
    ``dense_prefix`` holds the leading dense layers one by one."""
    d = cfg.d_model
    n_scan = cfg.num_layers - cfg.first_k_dense
    tree = common.embed_shapes(cfg)
    if cfg.frontend_stub and cfg.family == "vlm":
        tree["patch_proj"] = ((d, d), d)
    if cfg.is_moe:
        tree["layers"] = {
            "norm1": ((n_scan, d), None),
            "norm2": ((n_scan, d), None),
            "attn": common.attn_shapes(cfg, (n_scan,)),
            "moe": moe_mod.moe_param_shapes(cfg, n_scan),
        }
    else:
        tree["layers"] = _dense_layer_shapes(cfg, (n_scan,), mlp_width(cfg))
    if cfg.first_k_dense:
        tree["dense_prefix"] = {
            f"layer_{i}": _dense_layer_shapes(cfg, (), mlp_width(cfg))
            for i in range(cfg.first_k_dense)}
    return tree


def mlp_width(cfg: ModelConfig) -> int:
    """A dense layer's MLP width: ``d_ff``; in an MoE model (deepseek-moe
    style: its dense prefix) the total activated width."""
    return (cfg.moe_d_ff * (cfg.num_shared_experts + cfg.experts_per_token)
            if cfg.is_moe else cfg.d_ff)


def _dense_layer_axes(cfg: ModelConfig, pre: tuple) -> Dict:
    return {"norm1": pre + ("norm",), "norm2": pre + ("norm",),
            "attn": common.attn_axes(cfg, pre), "mlp": common.mlp_axes(pre)}


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``param_shapes``' leaves, tree for tree (the
    reference's ``init`` returns them beside the parameters)."""
    tree = common.embed_axes()
    if cfg.frontend_stub and cfg.family == "vlm":
        tree["patch_proj"] = ("embed", None)
    pax = ("layers",)
    if cfg.is_moe:
        tree["layers"] = {"norm1": pax + ("norm",), "norm2": pax + ("norm",),
                          "attn": common.attn_axes(cfg, pax),
                          "moe": moe_mod.moe_param_axes(cfg)}
    else:
        tree["layers"] = _dense_layer_axes(cfg, pax)
    if cfg.first_k_dense:
        tree["dense_prefix"] = {f"layer_{i}": _dense_layer_axes(cfg, ())
                                for i in range(cfg.first_k_dense)}
    return tree


def head_mask(cfg: ModelConfig) -> Optional[torch.Tensor]:
    """Which of the ``q_heads`` query heads are real (None without
    padding): each KV group holds its real heads first, then zeroed pads,
    so GQA's head -> kv-head map ``h // (q_heads / kvh)`` is kept."""
    h = cfg.q_heads
    if h == cfg.num_heads:
        return None
    g_pad, g_real = h // cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    return (torch.arange(h) % g_pad) < g_real


def layer_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer is_global flag (gemma3's local:global pattern: every
    ``local_global_period``-th layer is global)."""
    if cfg.local_global_period <= 0:
        return np.ones((cfg.num_layers,), np.bool_)
    idx = np.arange(cfg.num_layers)
    return (idx + 1) % cfg.local_global_period == 0


class DecoderLM:
    """Functional decoder-only LM over an explicit parameter dict."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, remat: bool = True,
                 shd_rules=None, moe_impl: str = "gspmd"):
        if cfg.local_global_period > 0 and (cfg.is_moe or cfg.first_k_dense):
            # the reference's windowed stack runs ``layers/mlp`` on every
            # layer and has no dense prefix, so it cannot run these either
            raise NotImplementedError(
                f"{cfg.name}: local:global window rings with MoE layers or a "
                "dense prefix")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.remat = remat
        self.n_scan = cfg.num_layers - cfg.first_k_dense
        self.shd = Sharder(mesh, rules=shd_rules, tp_axes=TP_AXES,
                           tp_replicated=("router",))
        self.moe_impl = moe_impl

    # -- params ------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights N(0, 1/fan_in) on ``device``, filled layer by
        layer in place (no f32 copy of a bf16 model), from ``generator`` (a
        ``torch.Generator`` on that device). ``dtype`` None gives
        ``cfg.dtype`` (serving); training passes the master dtype,
        ``torch.float32``. Padded query heads get zero ``wq`` rows and
        ``wo`` columns."""
        dev = resolve_device(device)
        dtype = self.dtype if dtype is None else dtype
        params = common.init_tree(param_shapes(self.cfg), generator, dev,
                                  dtype)
        mask = head_mask(self.cfg)
        if mask is not None:
            mask = mask.to(device=dev, dtype=dtype)
            attns = [params["layers"]["attn"]] + [
                lp["attn"] for lp in params.get("dense_prefix", {}).values()]
            for a in attns:
                a["wq"].mul_(mask[:, None])
                a["wo"].mul_(mask[:, None, None])
        return params

    def param_axes(self) -> Dict:
        return param_axes(self.cfg)

    # -- forward -----------------------------------------------------------

    def _run_stack(self, x, params, *, positions, caches=None,
                   cache_pos=None, true_len=None):
        """Run the layer stack: the dense prefix, then the stacked layers
        (MoE with ``cfg.is_moe``). Returns (x, caches, aux): caches (a flat
        (k_all, v_all) [L,B,T,kvh,dh] pair, a paged pool's
        ``common.PagedLayers``, or gemma3's dict of global stacks and
        local rings) are written in place, layer by layer, the
        prefix on cache rows ``0..first_k_dense-1``; aux sums the stacked
        MoE layers' load-balance terms (0.0 without them)."""
        if isinstance(caches, dict):
            x, caches = self._run_stack_windowed(
                x, params, positions=positions, caches=caches,
                cache_pos=cache_pos, true_len=true_len)
            return x, caches, 0.0
        cfg = self.cfg
        rope_cs = common.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        flags = layer_flags(cfg)
        remat = caches is None and self.remat and torch.is_grad_enabled()
        split = None if caches is None else self.shd.cache_kv_split()
        layers = [(p, False, ("dense_prefix", k), False)
                  for k, p in params.get("dense_prefix", {}).items()]
        layers += [(p, cfg.is_moe, ("layers",), True)
                   for p in common.layers_of(params["layers"], self.n_scan)]
        aux = 0.0
        paged = isinstance(caches, common.PagedLayers)
        for i, (p, is_moe, path, stacked) in enumerate(layers):
            c = (None if caches is None else caches.layer(i) if paged
                 else (caches[0][i], caches[1][i]))
            layer = functools.partial(
                self._layer, positions=positions, is_global=bool(flags[i]),
                rope_cs=rope_cs, kv_cache=c, cache_pos=cache_pos,
                kv_split=split, is_moe=is_moe, use=(path, stacked))
            if remat:
                x, a = checkpoint(layer, x, p, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = layer(x, p)
            if paged:
                caches.put(i, c)
                del layer, c          # the views go before the next gather
            if is_moe:
                aux = aux + a
        return x, caches, aux

    def _layer(self, x, p, is_moe=False, use=None, **attn):
        """One layer: attention and the MLP (or MoE), each around its
        residual. Returns (x, the layer's aux: 0.0 without MoE). ``use``
        (the parameter path, stacked): where ``p`` sits in the tree, for
        the per-layer gather of a rank's blocks."""
        if use is not None:
            p = self.shd.use(p, *use[0], stacked=use[1])
        tp = self.shd.tp
        h, _ = common.attention(common.rms_norm(x, p["norm1"]), p["attn"],
                                self.cfg, tp=tp, **attn)
        x = x + h
        if is_moe:
            ff, aux = moe_mod.moe_apply(common.rms_norm(x, p["norm2"]),
                                        p["moe"], self.cfg, self.shd,
                                        impl=self.moe_impl)
            return x + ff, aux
        return self._mlp_block(x, p, tp), 0.0

    def _mlp_block(self, x, p, tp=None):
        """The residual MLP half of a dense layer (in an MoE model a
        dense-prefix layer, whose MLP matches the activated width)."""
        return x + common.mlp(common.rms_norm(x, p["norm2"]), p["mlp"], tp,
                              mlp_width(self.cfg))

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
        tp, split = self.shd.tp, self.shd.cache_kv_split("global")
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
            p = self.shd.use(common.layer_of(lp, i), "layers", stacked=True)
            y = common.rms_norm(x, p["norm1"])
            if is_global:
                h, _ = common.attention(
                    y, p["attn"], cfg, positions=positions, is_global=True,
                    rope_cs=rope_cs, kv_cache=(gk[lig], gv[lig]),
                    cache_pos=cache_pos, tp=tp, kv_split=split)
                lig += 1
            elif s == 1:
                h, _ = common.attention(
                    y, p["attn"], cfg, positions=positions, is_global=False,
                    rope_cs=rope_cs, kv_cache=(lk[lil], lv[lil]),
                    cache_pos=cache_pos, cache_slot=slot, k_positions=k_pos,
                    k_valid=k_pos >= 0, tp=tp)
                lil += 1
            else:
                h, (fk, fv) = common.attention(
                    y, p["attn"], cfg, positions=positions, is_global=False,
                    rope_cs=rope_cs, return_kv=True, tp=tp)
                rk, rv = self._ring_gather(
                    fk.to(lk.dtype), fv.to(lv.dtype),
                    s if true_len is None else int(true_len), w)
                lk[lil] = rk
                lv[lil] = rv
                lil += 1
            x = self._mlp_block(x + h, p, tp)
        return x, caches

    def _inputs_to_h(self, batch, params):
        """Token embeddings, with the VLM's projected patch embeddings
        (``batch["patch_embeddings"]`` [B, P, d]) prepended."""
        shd = self.shd
        x = common.embed(batch["tokens"], shd.leaves(params, "embedding"),
                         self.dtype, shd.tp, self.cfg.vocab_size)
        if self.cfg.family == "vlm" and "patch_embeddings" in batch:
            pe = batch["patch_embeddings"].to(self.dtype) @ shd.use(
                params["patch_proj"], "patch_proj").to(self.dtype)
            x = torch.cat([pe, x], dim=1)
        return x

    def head(self, params):
        """``final_norm`` and ``unembed`` as the logits use them (under
        tensor parallelism, the rank's vocabulary block)."""
        return self.shd.leaves(params, "final_norm", "unembed")

    def hidden(self, params, batch):
        """Final hidden states (pre-unembed) and the aux loss (0.0 without
        MoE layers): the chunked cross-entropy's input, which never
        materializes the [B,S,V] logits."""
        x = self._inputs_to_h(batch, params)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = self._run_stack(x, params, positions=positions)
        return x, aux

    def forward(self, params, batch):
        """Training/scoring forward: batch = {tokens [B,S],
        (patch_embeddings [B,P,d])} -> (logits [B,P+S,V], aux)."""
        x, aux = self.hidden(params, batch)
        return common.unembed(x, self.head(params)), aux

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

    def cache_axes(self):
        """The logical axes of ``init_cache``'s leaves."""
        ax = ("layers", "batch", "kv_seq", "act_kv_heads", None)
        if self.cfg.local_global_period > 0:
            # ring (window) caches are small: never worth seq-sharding
            axl = ("layers", "batch", None, "act_kv_heads", None)
            return {"global": (ax, ax), "local": (axl, axl)}
        return (ax, ax)

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
        x, caches, _ = self._run_stack(x, params, positions=positions,
                                       caches=caches, cache_pos=offset,
                                       true_len=true_len)
        if true_len is None:
            last = x[:, -1:]
        else:
            t = min(max(int(true_len), 1), x.shape[1])
            last = x[:, t - 1:t]
        return common.unembed(last, self.head(params)), caches

    def decode_step(self, params, token, pos, caches):
        """One decode step. token: [B,1] int; pos: a Python int or a [B]
        int tensor (each row decodes at its own position)."""
        shd = self.shd
        x = common.embed(token, shd.leaves(params, "embedding"), self.dtype,
                         shd.tp, self.cfg.vocab_size)
        if isinstance(pos, torch.Tensor):
            positions = pos.long()[:, None]                    # [B, 1]
        else:
            positions = torch.full((1,), int(pos), device=x.device)
        x, caches, _ = self._run_stack(x, params, positions=positions,
                                       caches=caches, cache_pos=pos)
        return common.unembed(x, self.head(params)), caches


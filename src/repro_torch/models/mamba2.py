"""Mamba2 (SSD) blocks and the Zamba2 hybrid (a Mamba2 backbone with one
*shared* attention and MLP block applied every ``cfg.attn_every`` layers,
with a KV cache of its own at each application site) [arXiv:2411.15242] —
the reference's ``models/mamba2.py`` on tensors.

The SSD scan is the chunkwise-parallel algorithm (intra-chunk masked
matmuls and inter-chunk state passing, cumulative log decays exponentiated
in f32 with no stabiliser, as in the reference); the single-step recurrence
used for decode agrees with it. The shared attention's prefill runs on the
flash kernel (causal, from the chunk's start over the whole cache row).

Serving state (``init_cache``): ``mamba`` holds (S [L,B,H,N,P], conv
[L,B,W-1,di+2N]) in f32 and each ``attn_{i}`` a (k, v) pair of
[B, max_seq, kvh, dh] in ``dtype``; ``prefill`` and ``decode_step`` write
it in place and return it.

On a rank's blocks (``Sharder.rank_blocks``: the sharded train and serve
steps) each layer computes its share over the ``model`` ranks
(``Sharder.tp``), as the reference's specs split the leaves
(``ssm_inner``, ``heads``, ``kv_heads``, ``mlp``, ``vocab``): a Mamba2
layer runs its block of the heads (4 of 64 at model 16) where they divide
over the ranks, else all of them. Its leaves, leaf by leaf:

- ``w_in`` ``[d, z|x|B|C|dt]`` stays the rank's contiguous block of
  columns, which crosses the z/x/B/C/dt boundaries (524 of 8384 at model
  16): the rank multiplies by its block and all-gathers the product over
  ``model`` (``common.gathered_product``), then takes the columns it uses:
  its heads' z, x and dt, and B and C whole (every head reads them). This
  moves activations, not weights: cheaper than gathering the weight at
  decode, dearer at train_4k;
- ``conv`` ``[W, x|B|C]`` is gathered whole (``tp_replicated``: 34 KB a
  layer), and so is the cached conv state at use (B x 3 x 4224 f32): the
  rank convolves every channel and writes back its own block of the new
  state;
- ``a_log``, ``d_skip`` and ``dt_bias`` are whole: the rank takes its
  heads' entries;
- ``out_norm`` is the RMS norm over the whole inner width: the ranks' sums
  of squares are all-reduced (``common.rms_norm_split``); where the heads
  stay whole each rank norms them all and keeps its channels;
- ``w_out`` is row-parallel, its partial products summed over ``model``.

The cached S splits over heads as the ``act_heads`` spec splits it. The
shared attention and MLP split their heads and width over ``model``
(``common.attention``, ``common.mlp``), and the shared attention's caches
split over KV heads, and for a batch of one over sequence too
(``Sharder.cache_kv_split``), as the transformer's do; the embedding and
the logits split the vocabulary.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import loops
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.models.xlstm import CHUNK, _causal_conv
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import Sharder

#: the logical axes whose ``model`` split the layers' compute consumes
TP_AXES = ("ssm_inner", "heads", "kv_heads", "mlp", "vocab")


def mamba_shapes(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    nh = di // cfg.head_dim
    cw = cfg.ssm_conv_width
    return {
        "norm": ((L, d), None),
        "w_in": ((L, d, 2 * di + 2 * n + nh), d),
        "conv": ((L, cw, di + 2 * n), cw),
        "a_log": ((L, nh), None),
        "d_skip": ((L, nh), "ones"),
        "dt_bias": ((L, nh), None),
        "out_norm": ((L, di), None),
        "w_out": ((L, di, d), di),
    }


def ssd_chunkwise(x, b_mat, c_mat, dt, a, state, chunk=CHUNK):
    """Chunkwise SSD. x: [B,T,H,P]; b_mat/c_mat: [B,T,N]; dt: [B,T,H] (>0,
    f32); a: [H] (<0). state: [B,H,N,P] f32. Returns (y [B,T,H,P] f32,
    new state).

    The state update's three-operand product (``"bsn,bshp,bsh->bhnp"``)
    folds the decay into x first and is then one batched matmul."""
    w = min(chunk, x.shape[1])
    assert x.shape[1] % w == 0, (x.shape[1], w)
    mask = torch.tril(torch.ones((w, w), dtype=torch.bool, device=x.device))
    # the chunks have one shape: without a gradient a dry-run runs the
    # first (core.loops.scan; under one, the block's remat recomputes them)
    chunks = list(zip(*(t.split(w, dim=1) for t in (x, b_mat, c_mat, dt))))
    S, ys = loops.scan(_ssd_chunk, (state,), chunks, (a, mask),
                         scale_grad=False)
    return torch.cat(ys, dim=1), S[0]


def _ssd_chunk(carry, xs, a, mask):
    """One chunk of ``ssd_chunkwise``: carry (S,) and the chunk's x
    [B,W,H,P], b/c [B,W,N], dt [B,W,H] -> (carry, y [B,W,H,P])."""
    S, = carry
    x, b_mat, c_mat, dtc = xs
    bs, w, nh, p = x.shape
    n = b_mat.shape[-1]
    xf = x.float()
    bf, cf = b_mat.float(), c_mat.float()
    logf = dtc * a                                         # [B,W,H] <= 0
    lc = torch.cumsum(logf, dim=1)
    ltot = lc[:, -1]                                       # [B,H]
    # intra-chunk
    dm = lc[:, :, None, :] - lc[:, None, :, :]             # [B,W,W,H]
    A = torch.where(mask[None, :, :, None], torch.exp(dm), 0.0)
    cb = cf @ bf.transpose(-1, -2)                         # [B,W,W]
    scores = cb[..., None] * A * dtc[:, None, :, :]        # [B,W,W,H]
    xh = xf.transpose(1, 2)                                # [B,H,W,P]
    y_intra = scores.permute(0, 3, 1, 2) @ xh              # [B,H,W,P]
    # inter-chunk
    y_inter = (cf[:, None] @ S) * torch.exp(lc).transpose(1, 2)[..., None]
    y = (y_intra + y_inter).transpose(1, 2)
    # state update
    sdecay = torch.exp(ltot[:, None] - lc) * dtc           # [B,W,H]
    xs_ = (xf * sdecay[..., None]).reshape(bs, w, nh * p)
    upd = (bf.transpose(-1, -2) @ xs_).reshape(bs, n, nh, p)
    S = torch.exp(ltot)[..., None, None] * S + upd.permute(0, 2, 1, 3)
    return (S,), y


def ssd_step(x, b_mat, c_mat, dt, a, state):
    """Single-step recurrence, in place on ``state`` [B,H,N,P]. x:
    [B,1,H,P]; b/c: [B,1,N]; dt: [B,1,H]. Returns (y [B,1,H,P], state)."""
    S = state
    xf = x[:, 0].float()                                   # [B,H,P]
    bf, cf = b_mat[:, 0].float(), c_mat[:, 0].float()      # [B,N]
    dtc = dt[:, 0]                                         # [B,H]
    S.mul_(torch.exp(dtc * a)[..., None, None])
    S.add_(bf[:, None, :, None] * (xf * dtc[..., None])[:, :, None, :])
    y = (cf[:, None, None, :] @ S)[:, :, 0]                # [B,H,P]
    return y[:, None], S


def mamba_block(x, p, cfg: ModelConfig, state, *, chunk=CHUNK, tp=None):
    """Residual Mamba2 block. ``state``: (S, conv_state) views written in
    place, or None (training). ``tp``: the ranks that split the block's
    compute (``TensorParallel``; module docstring); ``p`` and ``state``
    are then the rank's blocks."""
    b, t, d = x.shape
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    nh = di // cfg.head_dim
    pdim = cfg.head_dim
    heads = common.rank_heads(tp, nh)
    y = common.rms_norm(x, p["norm"])
    proj = common.gathered_product(y, p["w_in"], tp, 2 * di + 2 * n + nh)
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt_raw = proj[..., di + di + 2 * n:]                   # [B,T,H]
    a_log, dt_bias, d_skip = p["a_log"], p["dt_bias"], p["d_skip"]
    if heads is not None:                  # the rank's heads' entries
        dt_raw = dt_raw[..., heads]
        a_log, dt_bias, d_skip = a_log[heads], dt_bias[heads], d_skip[heads]
    if state is None:
        S = torch.zeros((b, dt_raw.shape[-1], n, pdim), dtype=torch.float32,
                        device=x.device)
        conv_state = conv_in = None
    else:
        S, conv_state = state
        conv_in = conv_state
        blk = common.rank_block(tp, conv_state.shape[-1], di + 2 * n)
        if blk is not None:
            conv_in = comm.all_gather(conv_state, tp.group, dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv"], conv_in)
    xbc = F.silu(xbc)
    xssm = xbc[..., :di].reshape(b, t, nh, pdim)
    if heads is not None:
        xssm = xssm[:, :, heads]
    b_mat = xbc[..., di:di + n]
    c_mat = xbc[..., di + n:]
    dt = common.softplus(dt_raw.float() + dt_bias.float())
    a = -torch.exp(a_log.float())                          # [H] < 0
    if t == 1 and state is not None:
        ys, _ = ssd_step(xssm, b_mat, c_mat, dt, a, S)
    else:
        ys, S2 = ssd_chunkwise(xssm, b_mat, c_mat, dt, a, S,
                               chunk=min(chunk, t))
        if state is not None:
            S.copy_(S2)
    if state is not None:
        conv_state.copy_(new_conv if blk is None else new_conv[..., blk])
    ys = ys + d_skip.float()[:, None] * xssm.float()
    h = ys.reshape(b, t, -1).to(x.dtype)
    cols = common.rank_block(tp, p["w_out"].shape[0], di)
    if heads is not None:                  # the rank's heads' channels
        h = common.rms_norm_split(h, p["out_norm"], tp)
    else:
        h = common.rms_norm(h, p["out_norm"], cols=cols)
    if cols is not None:
        z = z[..., cols]
    h = h * F.silu(z)
    return x + common.row_product(h, p["w_out"], tp, di)


def param_shapes(cfg: ModelConfig) -> Dict:
    """The reference init's tree as (shape, fan_in) leaves."""
    tree = common.embed_shapes(cfg)
    tree["mamba"] = mamba_shapes(cfg, Zamba2(cfg).n_mamba)
    d = cfg.d_model
    tree["shared_attn"] = {            # ONE block, shared across sites
        "norm1": ((d,), None),
        "norm2": ((d,), None),
        "attn": common.attn_shapes(cfg),
        "mlp": common.mlp_shapes(d, cfg.d_ff),
    }
    return tree


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``param_shapes``' leaves, tree for tree."""
    pax = ("layers",)
    tree = common.embed_axes()
    tree["mamba"] = {
        "norm": pax + ("norm",),
        "w_in": pax + ("embed", "ssm_inner"),
        "conv": pax + ("conv_width", "ssm_inner"),
        "a_log": pax + (None,),
        "d_skip": pax + (None,),
        "dt_bias": pax + (None,),
        "out_norm": pax + ("ssm_inner",),
        "w_out": pax + ("ssm_inner", "embed"),
    }
    tree["shared_attn"] = {"norm1": ("norm",), "norm2": ("norm",),
                           "attn": common.attn_axes(cfg),
                           "mlp": common.mlp_axes()}
    return tree


class Zamba2:
    """A Mamba2 stack with one shared attention + MLP block every
    ``attn_every`` layers."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, shd_rules=None):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.shd = Sharder(mesh, rules=shd_rules, tp_axes=TP_AXES,
                           tp_replicated=("conv",))
        every = cfg.attn_every or (cfg.num_layers + 1)
        self.attn_sites = [i for i in range(cfg.num_layers)
                           if (i + 1) % every == 0]
        self.groups = []
        start = 0
        for si in self.attn_sites + [cfg.num_layers]:
            self.groups.append(si - start)
            start = si + 1
        self.n_mamba = cfg.num_layers - len(self.attn_sites)

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights N(0, 1/fan_in) on ``device`` from ``generator``
        (``d_skip`` ones); ``dtype`` None gives ``cfg.dtype``."""
        return common.init_tree(param_shapes(self.cfg), generator,
                                resolve_device(device),
                                self.dtype if dtype is None else dtype)

    def param_axes(self) -> Dict:
        return param_axes(self.cfg)

    def _shared_attn(self, x, p, positions, cache, cache_pos, tp=None,
                     kv_split=None):
        h, _ = common.attention(common.rms_norm(x, p["norm1"]), p["attn"],
                                self.cfg, positions=positions,
                                kv_cache=cache, cache_pos=cache_pos, tp=tp,
                                kv_split=kv_split)
        x = x + h
        return x + common.mlp(common.rms_norm(x, p["norm2"]), p["mlp"], tp,
                              self.cfg.d_ff)

    def _stack(self, x, params, states, *, positions, cache_pos=None):
        """The layers in order; ``states`` (None in training) written in
        place."""
        # under a gradient each block is recomputed in the backward (the
        # reference's jax.checkpoint(nothing_saveable) scan body)
        remat = states is None and torch.is_grad_enabled()
        mamba = common.layers_of(params["mamba"], self.n_mamba)
        split = (None if states is None or not self.attn_sites
                 else self.shd.cache_kv_split("attn_0", dim=1))
        li = 0
        for gi, g_count in enumerate(self.groups):
            for _ in range(g_count):
                st = (None if states is None
                      else tuple(s[li] for s in states["mamba"]))
                if remat:
                    x = checkpoint(self._mamba, x, mamba[li], st,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = self._mamba(x, mamba[li], st)
                li += 1
            if gi < len(self.attn_sites):
                cache = None if states is None else states[f"attn_{gi}"]
                x = self._shared_attn(
                    x, self.shd.use(params["shared_attn"], "shared_attn"),
                    positions, cache, cache_pos, self.shd.tp, split)
        return x

    def _mamba(self, x, p, st):
        """One Mamba2 layer on its slice ``p`` of the stacked leaves (a
        rank's blocks gathered here, inside the checkpoint)."""
        return mamba_block(x, self.shd.use(p, "mamba", stacked=True),
                           self.cfg, st, tp=self.shd.tp)

    def forward(self, params, batch):
        """Training/scoring forward: (logits [B,S,V], aux 0.0)."""
        shd = self.shd
        x = common.embed(batch["tokens"], shd.leaves(params, "embedding"),
                         self.dtype, shd.tp, self.cfg.vocab_size)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._stack(x, params, None, positions=positions)
        return common.unembed(x, shd.leaves(params, "final_norm",
                                            "unembed")), 0.0

    def cache_axes(self):
        """The logical axes of ``init_cache``'s leaves."""
        st = {"mamba": (("layers", "batch", "act_heads", None, None),
                        ("layers", "batch", None, "ssm_inner"))}
        for i in range(len(self.attn_sites)):
            ax = ("batch", "kv_seq", "act_kv_heads", None)
            st[f"attn_{i}"] = (ax, ax)
        return st

    def init_cache(self, batch_size, max_seq, dtype=torch.bfloat16,
                   device: DeviceLike = None):
        """Zero state: f32 mamba state and conv carry, ``dtype`` KV."""
        cfg = self.cfg
        dev = resolve_device(device)
        di = cfg.ssm_expand * cfg.d_model
        n = cfg.ssm_state
        nh = di // cfg.head_dim
        lm = self.n_mamba
        f32 = dict(dtype=torch.float32, device=dev)
        st = {"mamba": (
            torch.zeros((lm, batch_size, nh, n, cfg.head_dim), **f32),
            torch.zeros((lm, batch_size, cfg.ssm_conv_width - 1,
                         di + 2 * n), **f32))}
        shape = (batch_size, max_seq, cfg.num_kv_heads, cfg.head_dim)
        for i in range(len(self.attn_sites)):
            st[f"attn_{i}"] = (torch.zeros(shape, dtype=dtype, device=dev),
                               torch.zeros(shape, dtype=dtype, device=dev))
        return st

    def prefill(self, params, batch, states, start_pos=None):
        """Prefill a chunk at absolute positions [start, start+S): the
        mamba state and conv carry resume left to right across chunks, and
        ``start_pos`` offsets the shared attention's KV writes, RoPE and
        causal mask, so a prompt can be fed in pow2 chunks. Returns (logits
        of the last token [B,1,V], states), written in place."""
        shd = self.shd
        x = common.embed(batch["tokens"], shd.leaves(params, "embedding"),
                         self.dtype, shd.tp, self.cfg.vocab_size)
        offset = 0 if start_pos is None else int(start_pos)
        positions = torch.arange(x.shape[1], device=x.device) + offset
        x = self._stack(x, params, states, positions=positions,
                        cache_pos=offset)
        return common.unembed(x[:, -1:], shd.leaves(
            params, "final_norm", "unembed")), states

    def decode_step(self, params, token, pos, states):
        """One decode step. pos: a Python int or a [B] int tensor (each row
        decodes at its own attention position)."""
        shd = self.shd
        x = common.embed(token, shd.leaves(params, "embedding"), self.dtype,
                         shd.tp, self.cfg.vocab_size)
        if isinstance(pos, torch.Tensor):
            positions = pos.long()[:, None]                # [B, 1]
        else:
            positions = torch.full((1,), int(pos), device=x.device)
        x = self._stack(x, params, states, positions=positions,
                        cache_pos=pos)
        return common.unembed(x, shd.leaves(params, "final_norm",
                                            "unembed")), states

"""xLSTM (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel) and
sLSTM (scalar memory, time-recurrent) blocks — the reference's
``models/xlstm.py`` on tensors.

Layer pattern: every ``cfg.slstm_every``-th block is sLSTM, the rest mLSTM
(7:1 for xlstm-1.3b). The mLSTM layers' parameters and states are stacked
``[L, ...]`` (``mlstm/...``) as in the reference, the sLSTM layers' kept one
by one (``slstm_{i}``); a Python loop over the layers takes the place of
the reference's group scans.

Numerics, as in the reference: gates in f32; the input-gate pre-activation
is clamped at ``I_CLAMP`` instead of carrying a running-max stabiliser, so
the chunkwise and the recurrent forms agree. The chunkwise form
exponentiates cumulative log gates in f32 with no stabiliser either.

Serving state (``init_cache``): ``mlstm`` holds (C [L,B,NH,dh,dh], n
[L,B,NH,dh], conv [L,B,3,di]) and each ``slstm_{i}`` (c, n, m, h) of
[B,NH,dh], all f32. ``prefill`` and ``decode_step`` update it in place and
return it: a decode step scales C and adds the rank-1 update in place (one
batched matmul with a k of 1), so the 16 MB a row and a layer of
xlstm-1.3b's C are never copied.

On a rank's blocks (``Sharder.rank_blocks``: the sharded train and serve
steps) each block computes its share over the ``model`` ranks
(``Sharder.tp``), as the reference's specs split the leaves
(``ssm_inner``, ``heads``, ``mlp``, ``vocab``). In the mLSTM, ``w_up``
``[d, xi|z]`` stays the rank's contiguous block of columns, which need not
line up with the inner channels the rank uses (512 of 8192 at model 16):
the rank multiplies by its block and all-gathers the product over
``model`` (``common.gathered_product``: activations move, not weights).
``conv`` splits on the inner width as ``xi``'s channels do, so the rank
convolves its channels with its own block of the cached conv state;
``wq``, ``wk``, ``wv`` and ``w_gates`` split on their input dim and are
row-parallel (each product summed over ``model``, ``b_gates`` added once
after the sum). The recurrence runs the rank's heads where they divide
over the ranks (the ``act_heads`` spec splits C and n so), else all of
them on every rank (4 heads at model 16); ``out_norm`` is the RMS norm
over the whole inner width (the ranks' sums of squares all-reduced where
the rank holds its heads' channels), ``w_down`` row-parallel. In the
sLSTM, ``w_in`` ``[d, 4 gates x heads x dh]`` is a product on the rank's
block all-gathered (one (gate, head) block a rank at model 16), ``r`` is
used whole (``tp_replicated``) and the recurrence runs every head on every
rank (a state split over heads is gathered at use and the rank writes
back its block); the FFN splits over ``mlp``. The embedding and the
logits split the vocabulary.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import loops
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import Sharder

I_CLAMP = 8.0  # clamp on the input-gate pre-activation (exp gate)
CHUNK = 256    # the chunkwise form's chunk (the reference's default)

#: the logical axes whose ``model`` split the layers' compute consumes
TP_AXES = ("ssm_inner", "heads", "mlp", "vocab")


def _ffn_width(d):  # llama-style 8/3 rounded to 64
    return int(np.ceil(8 * d / 3 / 64) * 64)


def mlstm_shapes(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    di = 2 * d                       # up-projection factor 2
    nh = cfg.num_heads
    return {
        "norm": ((L, d), None),
        "w_up": ((L, d, 2 * di), d),
        "conv": ((L, 4, di), 4),
        "wq": ((L, di, di), di),
        "wk": ((L, di, di), di),
        "wv": ((L, di, di), di),
        "w_gates": ((L, di, 2 * nh), di),
        "b_gates": ((L, 2 * nh), None),
        "out_norm": ((L, di), None),
        "w_down": ((L, di, d), di),
    }


def slstm_shapes(cfg: ModelConfig) -> Dict:
    d, nh = cfg.d_model, cfg.num_heads
    dh = d // nh
    return {
        "norm": ((d,), None),
        "w_in": ((d, 4 * d), d),
        "r": ((4, nh, dh, dh), dh),
        "b": ((4 * d,), None),
        "out_norm": ((d,), None),
        "ffn": common.mlp_shapes(d, _ffn_width(d)),
    }


def _causal_conv(x, w, state=None):
    """x: [B,T,C], w: [W,C] depthwise. state: [B,W-1,C] carried for decode.
    Returns (out, new_state); the new state keeps ``state``'s dtype (f32
    from ``init_cache``), so a decode step's signature never drifts."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
              for i in range(width))
    new_state = xp[:, -(width - 1):]
    if state is not None:
        new_state = new_state.to(state.dtype)
    return out, new_state


def _mlstm_gates(xi, p, nh, tp=None, di: int = 0):
    g = common.row_product(xi, p["w_gates"], tp, di)
    g = (g + p["b_gates"].to(xi.dtype)).float()
    logi = g[..., :nh].clamp_max(I_CLAMP)               # [B,T,NH]
    logf = common.log_sigmoid(g[..., nh:])              # [B,T,NH] <= 0
    return logi, logf


def mlstm_chunkwise(q, k, v, logi, logf, state, chunk=CHUNK):
    """Chunkwise-parallel mLSTM. q, k, v: [B,T,NH,dh]; logi/logf:
    [B,T,NH]; state: (C [B,NH,dh,dh], n [B,NH,dh]) f32. Returns (h
    [B,T,NH,dh] f32, (C, n)) with new state tensors.

    The state update's three-operand product (``"bshd,bshe,bsh->bhde"`` in
    the reference) folds the decay into k first and is then one batched
    matmul, so no [.., W, dh, dh] intermediate exists."""
    b, t, nh, dh = q.shape
    w = min(chunk, t)
    assert t % w == 0, (t, w)
    scale = 1.0 / np.sqrt(dh)
    mask = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    # the chunks have one shape: without a gradient a dry-run runs the
    # first (core.loops.scan; under one, the block's remat recomputes them)
    chunks = list(zip(*(x.split(w, dim=1) for x in (q, k, v, logi, logf))))
    state, hs = loops.scan(_mlstm_chunk, tuple(state), chunks,
                             (mask, scale), scale_grad=False)
    return torch.cat(hs, dim=1), state


def _mlstm_chunk(state, xs, mask, scale):
    """One chunk of ``mlstm_chunkwise``: state (C, n) and the chunk's q,
    k, v [B,W,NH,dh] and log gates [B,W,NH] -> (state, h [B,W,NH,dh])."""
    C, n = state
    q, k, v, li, lf = xs
    # heads first: [B,NH,W,dh]
    qh = (q.float() * scale).transpose(1, 2)
    kh = k.float().transpose(1, 2)
    vh = v.float().transpose(1, 2)
    lc = torch.cumsum(lf, dim=1)                          # [B,W,NH] inclusive
    ltot = lc[:, -1]                                      # [B,NH]
    # intra-chunk: decay matrix A[t,s] = exp(lc_t - lc_s + li_s), s<=t
    dm = lc[:, :, None, :] - lc[:, None, :, :] + li[:, None, :, :]
    A = torch.where(mask[None, :, :, None], torch.exp(dm), 0.0)
    scores = (qh @ kh.transpose(-1, -2)) * A.permute(0, 3, 1, 2)
    num_intra = scores @ vh                               # [B,NH,W,dh]
    den_intra = scores.sum(dim=-1)                        # [B,NH,W]
    # inter-chunk: carried state decayed to each position
    decay_t = torch.exp(lc).transpose(1, 2)               # [B,NH,W]
    num_inter = (qh @ C) * decay_t[..., None]
    den_inter = (qh @ n[..., None])[..., 0] * decay_t
    den = (den_intra + den_inter).abs().clamp_min(1.0)
    h = ((num_intra + num_inter) / den[..., None]).transpose(1, 2)
    # state update: C' = exp(ltot) C + sum_s exp(ltot - lc_s + li_s) k v^T
    sdecay = torch.exp(ltot[:, None] - lc + li).transpose(1, 2)
    ks = kh * sdecay[..., None]                           # [B,NH,W,dh]
    e = torch.exp(ltot)
    C = e[..., None, None] * C + ks.transpose(-1, -2) @ vh
    n = e[..., None] * n + ks.sum(dim=-2)
    return (C, n), h


def mlstm_step(q, k, v, logi, logf, state):
    """Single-token recurrence, in place on ``state`` = (C [B,NH,dh,dh],
    n [B,NH,dh]). q, k, v: [B,1,NH,dh]. Returns (h [B,1,NH,dh], state)."""
    C, n = state
    b, _, nh, dh = q.shape
    qf = q[:, 0].float() / np.sqrt(dh)                    # [B,NH,dh]
    kf, vf = k[:, 0].float(), v[:, 0].float()
    i_ = torch.exp(logi[:, 0])                            # [B,NH]
    f_ = torch.exp(logf[:, 0])
    C.mul_(f_[..., None, None])
    C.view(b * nh, dh, dh).baddbmm_((i_[..., None] * kf).reshape(b * nh, dh, 1),
                                    vf.reshape(b * nh, 1, dh))
    n.mul_(f_[..., None]).add_(i_[..., None] * kf)
    num = (qf[:, :, None, :] @ C)[:, :, 0]                # [B,NH,dh]
    den = (qf * n).sum(dim=-1).abs().clamp_min(1.0)
    return (num / den[..., None])[:, None], (C, n)


def mlstm_block(x, p, cfg: ModelConfig, state, *, chunk=CHUNK, tp=None):
    """Residual mLSTM block. ``state``: (C, n, conv_state) views written in
    place, or None (training: zero state, nothing carried). ``tp``: the
    ranks that split the block's compute (module docstring); ``p`` and
    ``state`` are then the rank's blocks."""
    b, t, d = x.shape
    di, nh = 2 * d, cfg.num_heads
    dh = di // nh
    heads = common.rank_heads(tp, nh)
    y = common.rms_norm(x, p["norm"])
    up = common.gathered_product(y, p["w_up"], tp, 2 * di)
    xi, z = up[..., :di], up[..., di:]
    # the rank's inner channels: the conv's, the row-parallel products'
    # inputs and the output gate's
    cols = common.rank_block(tp, p["conv"].shape[-1], di)
    if cols is not None:
        xi, z = xi[..., cols], z[..., cols]
    if state is None:
        conv_state = None
        nl = nh if heads is None else heads.stop - heads.start
        C = torch.zeros((b, nl, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, nl, dh), dtype=torch.float32, device=x.device)
    else:
        C, n, conv_state = state
    xc, new_conv = _causal_conv(xi, p["conv"], conv_state)
    xc = F.silu(xc)
    q = common.row_product(xc, p["wq"], tp, di).reshape(b, t, nh, dh)
    k = common.row_product(xc, p["wk"], tp, di).reshape(b, t, nh, dh)
    v = common.row_product(xi, p["wv"], tp, di).reshape(b, t, nh, dh)
    logi, logf = _mlstm_gates(xc, p, nh, tp, di)
    if heads is not None:
        q, k, v = q[:, :, heads], k[:, :, heads], v[:, :, heads]
        logi, logf = logi[..., heads], logf[..., heads]
    if t == 1 and state is not None:
        h, _ = mlstm_step(q, k, v, logi, logf, (C, n))
    else:
        h, (C2, n2) = mlstm_chunkwise(q, k, v, logi, logf, (C, n),
                                      chunk=min(chunk, t))
        if state is not None:
            C.copy_(C2)
            n.copy_(n2)
    if state is not None:
        conv_state.copy_(new_conv)
    h = h.reshape(b, t, -1).to(x.dtype)
    if heads is not None:                  # the rank's heads' channels
        h = common.rms_norm_split(h, p["out_norm"], tp)
    else:
        h = common.rms_norm(h, p["out_norm"], cols=cols)
    h = h * F.silu(z)                                     # output gate
    return x + common.row_product(h, p["w_down"], tp, di)


def _slstm_step(carry, wx_t, r):
    """One token of the sLSTM: carry (c, n, m, h), the token's input
    projection [B,4,NH,dh] and the recurrent weights laid out once for a
    batched product over the heads, ``r`` [NH, dh, 4*dh] -> (carry,
    h)."""
    c, n, m, h = carry
    b, nh, dh = h.shape
    rec = torch.bmm(h.transpose(0, 1), r)                 # [NH,B,4*dh]
    pre = wx_t + rec.reshape(nh, b, 4, dh).permute(1, 2, 0, 3)
    zi, ii, fi, oi = pre.unbind(1)
    zi = torch.tanh(zi)
    oi = torch.sigmoid(oi)
    logi = ii.clamp_max(I_CLAMP)
    logf = common.log_sigmoid(fi)
    m_new = torch.maximum(logf + m, logi)
    i_ = torch.exp(logi - m_new)
    f_ = torch.exp(logf + m - m_new)
    c = f_ * c + i_ * zi
    n = f_ * n + i_
    h = oi * c / n.abs().clamp_min(1.0)
    return (c, n, m_new, h), h


def slstm_block(x, p, cfg: ModelConfig, state, tp=None):
    """Time-recurrent sLSTM with exponential gating and its stabiliser ``m``
    (which starts at -1e30, so the first step's gates reduce correctly): a
    Python loop over the tokens, the reference's ``lax.scan``.

    state: (c, n, m, h), each [B, NH, dh] f32, written in place; or None
    (zeros). ``tp``: the ranks that split the block's compute (module
    docstring); ``p`` and ``state`` are then the rank's blocks. Returns
    x."""
    b, t, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    y = common.rms_norm(x, p["norm"])
    wx = common.gathered_product(y, p["w_in"], tp, 4 * d)
    wx = (wx + p["b"].to(wx.dtype)).float().reshape(b, t, 4, nh, dh)
    # [4,NH,dh,dh] -> [NH,dh,4*dh], once: a per-token einsum would lay it
    # out (and, under a gradient, save a copy of it) at every token
    r = p["r"].float().permute(1, 2, 0, 3).reshape(nh, dh, 4 * dh)
    heads = None
    if state is None:
        zeros = torch.zeros((b, nh, dh), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, torch.full_like(zeros, -1e30), zeros)
    else:
        carry = state
        heads = common.rank_block(tp, state[0].shape[1], nh)
        if heads is not None:
            # the recurrence runs every head: the rank's blocks gathered
            carry = tuple(comm.all_gather(s, tp.group, dim=1) for s in state)
    # the tokens have one shape: a dry-run runs the first (core.loops.scan)
    (c, n, m, h), hs = loops.scan(_slstm_step, tuple(carry),
                                    wx.unbind(1), (r,))
    if state is not None:
        for dst, src in zip(state, (c, n, m, h)):
            dst.copy_(src if heads is None else src[:, heads])
    hseq = torch.stack(hs, dim=1).reshape(b, t, d).to(x.dtype)
    x = x + common.rms_norm(hseq, p["out_norm"])
    return x + common.mlp(common.rms_norm(x, p["norm"]), p["ffn"], tp,
                          _ffn_width(d))


def param_shapes(cfg: ModelConfig) -> Dict:
    """The reference init's tree as (shape, fan_in) leaves."""
    model = XLSTM(cfg)
    tree = common.embed_shapes(cfg)
    tree["mlstm"] = mlstm_shapes(cfg, model.n_mlstm)
    for i in range(len(model.slstm_idx)):
        tree[f"slstm_{i}"] = slstm_shapes(cfg)
    return tree


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``param_shapes``' leaves, tree for tree."""
    pax = ("layers",)
    tree = common.embed_axes()
    tree["mlstm"] = {
        "norm": pax + ("norm",),
        "w_up": pax + ("embed", "ssm_inner"),
        "conv": pax + ("conv_width", "ssm_inner"),
        "wq": pax + ("ssm_inner", None),
        "wk": pax + ("ssm_inner", None),
        "wv": pax + ("ssm_inner", None),
        "w_gates": pax + ("ssm_inner", None),
        "b_gates": pax + (None,),
        "out_norm": pax + ("ssm_inner",),
        "w_down": pax + ("ssm_inner", "embed"),
    }
    for i in range(len(XLSTM(cfg).slstm_idx)):
        tree[f"slstm_{i}"] = {
            "norm": ("norm",),
            "w_in": ("embed", "ssm_inner"),
            "r": (None, "heads", None, None),
            "b": (None,),
            "out_norm": ("norm",),
            "ffn": common.mlp_axes(),
        }
    return tree


class XLSTM:
    """Functional xLSTM over an explicit parameter dict."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, shd_rules=None):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.shd = Sharder(mesh, rules=shd_rules, tp_axes=TP_AXES,
                           tp_replicated=("r",))
        every = cfg.slstm_every or (cfg.num_layers + 1)
        self.slstm_idx = [i for i in range(cfg.num_layers)
                          if (i + 1) % every == 0]
        # groups of consecutive mLSTM layers before each sLSTM layer
        self.groups = []
        start = 0
        for si in self.slstm_idx + [cfg.num_layers]:
            self.groups.append(si - start)
            start = si + 1
        self.n_mlstm = cfg.num_layers - len(self.slstm_idx)

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

    def _stack(self, x, params, states):
        """The layers in order; ``states`` (None in training) written in
        place."""
        # under a gradient each mLSTM block is recomputed in the backward
        # (the reference's jax.checkpoint(nothing_saveable) scan body). The
        # sLSTM layers run outside any checkpoint, as in the reference, so
        # a rank keeps each one's gathered weights until the backward
        remat = states is None and torch.is_grad_enabled()
        mlstm = common.layers_of(params["mlstm"], self.n_mlstm)
        li = 0
        for gi, g_count in enumerate(self.groups):
            for _ in range(g_count):
                st = (None if states is None
                      else tuple(s[li] for s in states["mlstm"]))
                if remat:
                    x = checkpoint(self._mlstm, x, mlstm[li], st,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = self._mlstm(x, mlstm[li], st)
                li += 1
            if gi < len(self.slstm_idx):
                name = f"slstm_{gi}"
                st = None if states is None else states[name]
                x = slstm_block(x, self.shd.use(params[name], name),
                                self.cfg, st, self.shd.tp)
        return x

    def _mlstm(self, x, p, st):
        """One mLSTM layer on its slice ``p`` of the stacked leaves (a
        rank's blocks gathered here, inside the checkpoint)."""
        return mlstm_block(x, self.shd.use(p, "mlstm", stacked=True),
                           self.cfg, st, tp=self.shd.tp)

    def forward(self, params, batch):
        """Training/scoring forward: (logits [B,S,V], aux 0.0)."""
        shd = self.shd
        x = common.embed(batch["tokens"], shd.leaves(params, "embedding"),
                         self.dtype, shd.tp, self.cfg.vocab_size)
        x = self._stack(x, params, None)
        return common.unembed(x, shd.leaves(params, "final_norm",
                                            "unembed")), 0.0

    # -- serving: the state is O(1) in sequence length -----------------------

    def cache_axes(self):
        """The logical axes of ``init_cache``'s leaves."""
        st = {"mlstm": (("layers", "batch", "act_heads", None, None),
                        ("layers", "batch", "act_heads", None),
                        ("layers", "batch", None, "ssm_inner"))}
        for i in range(len(self.slstm_idx)):
            ax = ("batch", "act_heads", None)
            st[f"slstm_{i}"] = (ax, ax, ax, ax)
        return st

    def init_cache(self, batch_size, max_seq, dtype=torch.bfloat16,
                   device: DeviceLike = None):
        """Zero state for ``batch_size`` rows (``max_seq`` and ``dtype`` are
        taken for the uniform signature: every leaf is f32)."""
        cfg = self.cfg
        dev = resolve_device(device)
        d, nh = cfg.d_model, cfg.num_heads
        di = 2 * d
        dh = di // nh
        lm = self.n_mlstm

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        st = {"mlstm": (zeros(lm, batch_size, nh, dh, dh),
                        zeros(lm, batch_size, nh, dh),
                        zeros(lm, batch_size, 3, di))}
        sdh = d // nh
        for i in range(len(self.slstm_idx)):
            st[f"slstm_{i}"] = (zeros(batch_size, nh, sdh),
                                zeros(batch_size, nh, sdh),
                                torch.full((batch_size, nh, sdh), -1e30,
                                           device=dev),
                                zeros(batch_size, nh, sdh))
        return st

    def prefill(self, params, batch, states, start_pos=None):
        """Prefill a chunk, resuming the carried state in ``states`` (in
        place). mLSTM and sLSTM are position-free, so ``start_pos`` is
        taken for the uniform chunked-prefill signature and ignored.
        Returns (logits of the last token [B,1,V], states)."""
        del start_pos
        shd = self.shd
        x = common.embed(batch["tokens"], shd.leaves(params, "embedding"),
                         self.dtype, shd.tp, self.cfg.vocab_size)
        x = self._stack(x, params, states)
        return common.unembed(x[:, -1:], shd.leaves(
            params, "final_norm", "unembed")), states

    def decode_step(self, params, token, pos, states):
        del pos  # position-free
        shd = self.shd
        x = common.embed(token, shd.leaves(params, "embedding"), self.dtype,
                         shd.tp, self.cfg.vocab_size)
        x = self._stack(x, params, states)
        return common.unembed(x, shd.leaves(params, "final_norm",
                                            "unembed")), states

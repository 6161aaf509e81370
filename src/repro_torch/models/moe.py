"""Fine-grained Mixture-of-Experts (deepseek-moe / moonlight style).

Shared experts (always-on, fused into one dense SwiGLU) plus routed experts
with top-k routing, a fixed capacity and token dropping, as the reference's
``_moe_apply_gspmd``: tokens are split into ``groups`` row blocks
(``gcd(B, 32)`` without a mesh; one per batch shard with one), each block
routes on its own, and the expert products are batched matmuls over all
experts. ``moe_apply_shard_map`` is the reference's expert parallelism:
each ``model`` rank runs its own experts, and the dispatch buffers move by
all-to-all. On a rank's blocks under tensor parallelism the router runs
whole on every rank and the shared experts split like a dense MLP; on the
grouped path every rank routes every token alike and runs only its own
experts (``experts`` over ``model``, as GSPMD splits the reference's
einsums), and the ranks' partial combines are summed.

Three places where the port must take care to give the reference's
integers, not only its floats:

- *Ties in top-k.* ``lax.top_k`` puts the lower expert index first among
  equal probabilities, and ``torch.topk`` promises no order; router logits
  in bf16 tie often among 64 experts. ``top_k`` is a stable descending
  sort cut to ``k``.
- *Capacity order.* Tokens past an expert's capacity are dropped in the
  order of a stable argsort of the flat expert ids (``torch.sort(...,
  stable=True)`` and ``searchsorted(side="left")``), so which token drops
  depends on the whole group: a bucketed prefill routes its pad tokens,
  and in a decode step the batch's rows compete for each expert.
- *The combine.* The reference adds each token's ``k`` contributions with a
  scatter-add; on the card ``index_add_`` would add them with atomics in a
  different order each run. ``combine`` gathers them into ``[T, k, D]`` in
  ascending expert order (the order the reference's sorted scatter adds
  them) and sums over ``k``: the same tokens on every run.

The expert products are plain batched matmuls in the reference (outside any
Pallas kernel), so they are ``torch.einsum`` here.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import mesh_shape

#: one routing group per batch shard; on one device the reference's
#: default (``n_shards`` 32) gives ``gcd(B, 32)`` groups
N_SHARDS = 32


def shared_width(cfg: ModelConfig) -> int:
    """The shared experts' SwiGLU width."""
    return cfg.num_shared_experts * cfg.moe_d_ff


def moe_param_shapes(cfg: ModelConfig, L: int) -> Dict:
    """The ``moe`` subtree of ``L`` stacked layers as (shape, fan_in)
    leaves: the router, the routed experts and, with shared experts, one
    dense SwiGLU of width ``num_shared_experts * moe_d_ff``."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    tree = {
        "router": ((L, d, e), d),
        "w_gate": ((L, e, d, f), d),
        "w_up": ((L, e, d, f), d),
        "w_down": ((L, e, f, d), f),
    }
    if cfg.num_shared_experts:
        fs = shared_width(cfg)
        tree["shared"] = {"w_gate": ((L, d, fs), d), "w_up": ((L, d, fs), d),
                          "w_down": ((L, fs, d), fs)}
    return tree


def moe_param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``moe_param_shapes``' stacked leaves."""
    pax = ("layers",)
    tree = {
        "router": pax + ("embed", "experts"),
        "w_gate": pax + ("experts", "embed", "expert_mlp"),
        "w_up": pax + ("experts", "embed", "expert_mlp"),
        "w_down": pax + ("experts", "expert_mlp", "embed"),
    }
    if cfg.num_shared_experts:
        tree["shared"] = common.mlp_axes(pax)
    return tree


def n_groups(batch: int) -> int:
    """Routing groups for a batch of ``batch`` rows on one device."""
    return math.gcd(batch, N_SHARDS)


def capacity_for(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots an expert has in a group: ``ceil(capacity_factor * tg * k /
    E)``, at least 1."""
    return max(int(math.ceil(cfg.capacity_factor * tokens_per_group
                             * cfg.experts_per_token / cfg.num_experts)), 1)


def top_k(probs, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xg, logits, cfg: ModelConfig, capacity: int):
    """Group-local routing of ``G`` groups at once, ``_route_group``'s
    semantics. xg [G, T, D]; logits [G, T, E].

    Returns (dispatch [G, E, C, D], (slot, tok, order) each [G, T*k] in
    sorted-expert order, weights [G, T, k] f32, keep [G, T*k], aux [G]).
    ``slot`` is ``e * C + rank`` for a kept token and the trash row
    ``E * C`` for a dropped one."""
    g, t, d = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(logits.float(), dim=-1)               # [G, T, E]
    weights, ids = top_k(probs, k)                              # [G, T, k]
    weights = weights / weights.sum(dim=-1, keepdim=True)

    ids_flat = ids.reshape(g, t * k)
    sorted_eid, order = torch.sort(ids_flat, dim=-1, stable=True)
    experts = torch.arange(e, device=xg.device).expand(g, e).contiguous()
    start = torch.searchsorted(sorted_eid, experts, side="left")  # [G, E]
    rank = (torch.arange(t * k, device=xg.device)
            - start.gather(1, sorted_eid))                      # within-expert
    keep = rank < capacity
    slot = torch.where(keep, sorted_eid * capacity + rank,
                       torch.full_like(rank, e * capacity))
    tok = order // k                                            # source token

    # each kept slot is written once; every dropped token lands on the
    # trash row, which is cut off
    src = xg.gather(1, tok[..., None].expand(g, t * k, d))
    buf = torch.zeros((g, e * capacity + 1, d), dtype=xg.dtype,
                      device=xg.device)
    buf.scatter_(1, slot[..., None].expand(g, t * k, d), src)
    dispatch = buf[:, :-1].reshape(g, e, capacity, d)

    # aux (load-balance) loss terms, Switch-style: frac is the mean of the
    # top-1 one-hots, counted with a scatter (exact in any order)
    top1 = torch.zeros((g, e), dtype=torch.float32, device=xg.device)
    top1.scatter_add_(1, ids[..., 0], torch.ones_like(weights[..., 0]))
    aux = e * (top1 / t * probs.mean(dim=1)).sum(dim=-1)
    return dispatch, (slot, tok, order), weights, keep, aux


def combine(expert_out, routing, weights, keep, t: int, k: int,
            first: int = 0):
    """expert_out [G, E, C, D] -> y [G, T, D]: each token's ``k`` expert
    outputs, weighted (a dropped one by 0), summed in ascending expert
    order in a fixed reduction (``_combine_group``'s sum, without its
    scatter-add). With ``first``, ``expert_out`` holds the ``E`` experts
    from ``first`` on (a rank's): the others' choices add zero, and the
    result is the rank's partial sum."""
    g, e, c, d = expert_out.shape
    slot, tok, order = routing
    flat = torch.cat([expert_out.reshape(g, e * c, d),
                      expert_out.new_zeros((g, 1, d))], dim=1)
    w_flat = weights.reshape(g, t * k).gather(1, order)
    if first:
        slot = slot - first * c
    held = keep & (slot >= 0) & (slot < e * c)
    slot = torch.where(held, slot, torch.full_like(slot, e * c))
    w = torch.where(held, w_flat, torch.zeros((), device=w_flat.device))
    contrib = flat.gather(1, slot[..., None].expand(g, t * k, d))
    contrib = contrib * w.to(contrib.dtype)[..., None]          # sorted order
    # position of each (token, choice) in the sorted order; a token's
    # choices sorted by position run in ascending expert order
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(t * k, device=order.device)
                 .expand(g, t * k).contiguous())
    pos = pos.reshape(g, t, k).sort(dim=-1).values.reshape(g, t * k)
    return contrib.gather(1, pos[..., None].expand(g, t * k, d)).reshape(
        g, t, k, d).sum(dim=2)


def _experts(dispatch, wg, wu, wd, lead="g"):
    """The SwiGLU experts over a dispatch buffer [G, E, C, D] (``lead``
    "g") or [E, C, D] (``lead`` "") and weights [E, D, F], [E, D, F],
    [E, F, D]."""
    h = F.silu(torch.einsum(f"{lead}ecd,edf->{lead}ecf", dispatch, wg))
    h = h * torch.einsum(f"{lead}ecd,edf->{lead}ecf", dispatch, wu)
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", h, wd)


def _n_groups(b: int, shd, groups: int) -> int:
    """Routing groups for ``b`` rows: ``groups`` if given, else one per
    batch shard of the mesh (``gcd(B, 32)`` without one). On a DeviceMesh
    ``b`` is the rank's rows, and the rank routes its share of the global
    batch's groups."""
    if shd is None or shd.mesh is None:
        return groups if groups > 0 else n_groups(b)
    sizes = mesh_shape(shd.mesh)
    n_shards = math.prod(sizes[a] for a in shd.batch_axes(b))
    if not shd.local:
        return groups if groups > 0 else math.gcd(b, n_shards)
    total = groups if groups > 0 else math.gcd(b * n_shards, n_shards)
    if total % n_shards:
        raise ValueError(f"{total} routing groups over {n_shards} batch "
                         "shards")
    return total // n_shards


def _with_shared(y, x, p, cfg: ModelConfig, shd):
    """``y`` plus the shared experts' SwiGLU of ``x`` (split over the
    ``model`` ranks like a dense MLP under tensor parallelism)."""
    if not cfg.num_shared_experts:
        return y
    tp = None if shd is None else shd.tp
    return y + common.mlp(x, p["shared"], tp, shared_width(cfg))


def moe_apply(x, p, cfg: ModelConfig, shd=None, groups: int = 0,
              impl: str = "gspmd"):
    """x [B, S, D] -> (y [B, S, D], mean aux). ``impl="shard_map"`` on a
    DeviceMesh runs expert parallelism (:func:`moe_apply_shard_map`);
    otherwise the tokens route in groups (:func:`_n_groups`) and the
    expert products run over all experts, or over the rank's block of
    them under tensor parallelism, whose partial outputs are summed over
    the ``model`` ranks."""
    if impl == "shard_map" and shd is not None and shd.local:
        return moe_apply_shard_map(x, p, cfg, shd)
    b, s, d = x.shape
    k = cfg.experts_per_token
    groups = _n_groups(b, shd, groups)
    tg = b * s // groups
    capacity = capacity_for(cfg, tg)

    xf = x.reshape(groups, tg, d)
    logits = xf @ p["router"].to(x.dtype)                       # [G, T, E]
    dispatch, routing, weights, keep, aux = route(xf, logits, cfg, capacity)
    e_local = p["w_gate"].shape[0]
    tp = None if shd is None else shd.tp
    split = tp is not None and tp.splits(e_local, cfg.num_experts)
    first = tp.rank * e_local if split else 0
    if split:
        dispatch = dispatch[:, first:first + e_local]
    out = _experts(dispatch, p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype),
                   p["w_down"].to(x.dtype))
    y = combine(out, routing, weights, keep, tg, k, first).reshape(b, s, d)
    if split:
        y = tp.sum(y)
    return _with_shared(y, x, p, cfg, shd), aux.mean()


def moe_apply_shard_map(x, p, cfg: ModelConfig, shd):
    """Expert parallelism with explicit all-to-alls over the ``model``
    ranks (the reference's ``moe_apply_shard_map``).

    ``x`` is the rank's rows [B_l, S, D]. Unless the batch is split over
    ``model`` too, the ``model`` ranks hold the same rows and each routes
    its 1/TP slice of them; the ``[TP, E_l, C, D]`` dispatch buffer goes
    out by all-to-all, each rank runs its ``E / TP`` experts on the slots
    every peer sent it, the outputs come back by a second all-to-all, and
    the rank combines them and all-gathers the tokens over ``model``. The
    expert weights are the full ``[E, ...]`` tree (the rank takes its
    experts) or the rank's own ``[E_l, ...]`` block. ``aux`` is averaged
    over every rank."""
    mesh = shd.mesh
    e, k = cfg.num_experts, cfg.experts_per_token
    bl, s, d = x.shape
    tp = mesh_shape(mesh).get("model", 1)
    if e % tp:
        raise ValueError(f"{e} experts over {tp} model ranks")
    e_local = e // tp
    group = mesh.get_group("model")
    m = mesh.get_local_rank("model")
    cover = "model" in shd.batch_axes(bl)
    t_local = bl * s
    if cover:
        t_rank = t_local            # tokens already split over "model"
    else:
        if t_local % tp:
            raise ValueError(f"{t_local} tokens over {tp} model ranks")
        t_rank = t_local // tp      # each model rank routes its slice
    capacity = capacity_for(cfg, t_rank)

    xf = x.reshape(t_local, d)
    xr = xf if cover else xf[m * t_rank:(m + 1) * t_rank]
    xr = xr[None]                                               # one group
    logits = xr @ p["router"].to(x.dtype)
    dispatch, routing, weights, keep, aux = route(xr, logits, cfg, capacity)
    buf = dispatch[0].reshape(tp, e_local, capacity, d)
    # rank j receives every peer's slots for ITS experts
    recv = comm.all_to_all(buf, group)               # [tp(src), E_l, C, D]
    recv = recv.transpose(0, 1).reshape(e_local, tp * capacity, d)

    def mine(w):
        w = w[m * e_local:(m + 1) * e_local] if w.shape[0] == e else w
        return w.to(x.dtype)

    out = _experts(recv, mine(p["w_gate"]), mine(p["w_up"]),
                   mine(p["w_down"]), lead="")
    out = out.reshape(e_local, tp, capacity, d).transpose(0, 1)
    back = comm.all_to_all(out, group).reshape(1, e, capacity, d)
    yr = combine(back, routing, weights, keep, t_rank, k)[0]
    y = yr if cover else comm.all_gather(yr, group)
    aux = comm.all_reduce_mean(aux.mean(), comm.world_group(mesh))
    return _with_shared(y.reshape(bl, s, d), x, p, cfg, shd), aux

"""Logical-axis sharding: maps model-declared logical axes onto mesh axes.

The reference's layout (``repro.parallel.sharding``), kept rule for rule: a
fast intra-pod network carries the ``data`` and ``model`` mesh axes and a
slow inter-pod network the ``pod`` axis (DALEK's 2.5 GbE analogue).
Parameters are FSDP-sharded over ``data`` and tensor-parallel over
``model``; the ``pod`` axis only carries data parallelism (the gradient
all-reduce, optionally compressed: ``repro_torch.parallel.compress``).

Every parameter and key activation declares *logical* axes (e.g.
``("layers", "embed", "heads", "head_dim")``); :func:`spec_for` resolves
them to a :class:`PartitionSpec` with divisibility checks.

A mesh here is anything that names its axes' sizes: a dict of sizes, an
``AbstractMesh`` (``repro_torch.launch.mesh``) or a
``torch.distributed.DeviceMesh``. Where the reference pins GSPMD's
propagation, a rank here holds its own block of each tensor, so
:class:`Sharder` is the identity on activations; :class:`NamedSharding`
says which block a rank holds, cuts it from a full tensor and gathers it
back, whole or over some of its axes.

What GSPMD derives from the specs, a rank here does by the rule of
:meth:`Sharder.use`: while the model's parameters are the rank's blocks
(``Sharder.rank_blocks``), each layer gathers its own leaves where it
uses them, over every split axis but ``model`` on a dim whose compute
the model splits (heads, KV heads where they divide, MLP width,
vocabulary, experts), and computes its share of those products
(:class:`TensorParallel`). The gathers' backward is a reduce-scatter, so
a rank never holds a whole stacked leaf, its gradient included. Caches
given as blocks name their layout too (``rank_blocks``'s
``cache_specs``): a cache whose sequence is split is attended block by
block (:meth:`Sharder.kv_split`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping, NamedTuple, Optional, Sequence

import torch

from repro_torch.parallel import comm

# logical axis -> preferred mesh axis (None = replicate)
LOGICAL_RULES = {
    # parameter axes
    "layers": None,          # stacked-layer axis, never sharded
    "vocab": "model",        # TP over vocabulary (embed + unembed + logits)
    "embed": "data",         # FSDP: weight-shard d_model over the data axis
    "heads": "model",        # TP over attention heads
    "kv_heads": "model",     # TP over KV heads (dropped when indivisible: MQA)
    "head_dim": None,
    "mlp": "model",          # TP over FFN hidden
    "experts": "model",      # EP: experts over the model axis
    "expert_mlp": None,      # per-expert FFN hidden stays local
    "ssm_inner": "model",    # TP over SSM inner channels
    "ssm_state": None,
    "conv_width": None,
    "norm": None,
    # activation axes
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,          # overridden to "model" for seq-sharded caches
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_experts": "model",
    "act_vocab": "model",
    "act_mlp": "model",
    "qblock": None,
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names (split
    major to minor) or None (replicated)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict:
    """Axis name -> size of a dict, an ``AbstractMesh`` or a DeviceMesh."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def is_device_mesh(mesh) -> bool:
    """True for a DeviceMesh: tensors on it are each rank's own blocks."""
    return getattr(mesh, "mesh_dim_names", None) is not None


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_for(
    mesh,
    logical_axes: Sequence[Optional[str]],
    shape: Optional[Sequence[int]] = None,
    rules: Optional[dict] = None,
) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec.

    Mesh axes are dropped when (a) absent from the mesh or already used by
    an earlier dim or (b) the dim size is known and not divisible by the
    mesh axes' size (the last axis goes first). Trailing Nones are
    trimmed."""
    sizes = mesh_shape(mesh)
    rules = {**LOGICAL_RULES, **(rules or {})}
    used = set()
    out = []
    for i, name in enumerate(logical_axes):
        mesh_axis = rules.get(name) if name is not None else None
        keep = [a for a in spec_axes(mesh_axis)
                if a in sizes and a not in used]
        if shape is not None:
            size = math.prod(sizes[a] for a in keep)
            while keep and size > 0 and shape[i] % size != 0:
                size //= sizes[keep.pop()]
        if not keep:
            out.append(None)
        else:
            used.update(keep)
            out.append(tuple(keep) if len(keep) > 1 else keep[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _shape_of(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_specs(mesh, axes_tree, shape_tree=None, rules=None):
    """Map a tree (dicts and tuples) of logical-axis tuples, and optionally
    a matching tree of shapes (tensors, or anything with a ``shape``, or
    shape tuples), to PartitionSpecs."""
    def go(axes, shp):
        if _is_axes(axes):
            return spec_for(mesh, axes,
                            None if shp is None else _shape_of(shp), rules)
        if isinstance(axes, dict):
            return {k: go(v, None if shp is None else shp[k])
                    for k, v in axes.items()}
        return tuple(go(a, None if shp is None else s) for a, s in
                     zip(axes, shp if shp is not None else [None] * len(axes)))
    return go(axes_tree, shape_tree)


class NamedSharding:
    """A PartitionSpec on a mesh: the block of a tensor each rank holds.

    Along a dim split over axes ``(a1, a2)`` there are ``|a1| * |a2|``
    blocks, and the rank at coordinates ``(c1, c2)`` holds block ``c1 *
    |a2| + c2`` (major to minor, as JAX splits it). Ranks whose coordinates
    differ only on axes the spec does not name hold the same block."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.sizes = mesh_shape(mesh)

    def __repr__(self):
        return f"NamedSharding({self.sizes}, {self.spec!r})"

    @property
    def shards(self) -> int:
        """Distinct blocks of a tensor laid out by this spec."""
        return math.prod(self.sizes[a] for e in self.spec
                         for a in spec_axes(e))

    @property
    def replicas(self) -> int:
        """Ranks that hold each block."""
        return math.prod(self.sizes.values()) // self.shards

    def coords(self) -> dict:
        """The caller's mesh coordinates (axis -> index)."""
        return dict(zip(self.mesh.mesh_dim_names,
                        self.mesh.get_coordinate()))

    def block_slices(self, shape, coords: dict) -> tuple:
        """Per-dim slices of the block at ``coords`` of a tensor of
        ``shape``."""
        out = []
        for i, n in enumerate(shape):
            axes = spec_axes(self.spec[i]) if i < len(self.spec) else ()
            parts, idx = 1, 0
            for a in axes:
                parts *= self.sizes[a]
                idx = idx * self.sizes[a] + coords[a]
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def block(self, t: torch.Tensor, coords: Optional[dict] = None):
        """The block of the full tensor ``t`` at ``coords`` (the caller's
        rank for None): ``t`` itself when the spec splits nothing, else a
        contiguous copy that owns exactly its own bytes. A slice along the
        leading dim is contiguous already, but as a view it would keep the
        whole tensor's storage alive: it is cloned."""
        if self.shards == 1:
            return t
        if coords is None:
            coords = self.coords()
        b = t[self.block_slices(t.shape, coords)]
        if b.is_contiguous() and b.untyped_storage().nbytes() > b.nbytes:
            return b.clone()
        return b.contiguous()

    def full_shape(self, block_shape) -> tuple:
        """The full tensor's shape from one block's."""
        out = list(block_shape)
        for i, e in enumerate(self.spec):
            out[i] *= math.prod(self.sizes[a] for a in spec_axes(e))
        return tuple(out)

    def gather(self, block: torch.Tensor, axes=None) -> torch.Tensor:
        """The full tensor from every rank's block (an all-gather over the
        mesh's ranks, which are numbered row-major over its coordinates,
        as ``init_device_mesh`` and a ``RankMesh`` number them; the block
        itself when the spec splits nothing). With ``axes`` (mesh axis
        names) only the splits over those axes are undone, one all-gather
        an axis on that axis's group (``mesh.get_group``), whose backward
        reduce-scatters: the tensor stays split over the spec's other
        axes. Along a dim split over several axes the gathered ones must
        be its minor ones."""
        if axes is not None:
            return self._gather_axes(block, axes)
        if self.shards == 1:
            return block
        names = list(self.sizes)
        parts = comm.all_gather(block, comm.world_group(self.mesh))
        parts = parts.view(tuple(self.sizes.values()) + tuple(block.shape))
        # ranks that differ only on axes the spec does not name hold the
        # same block: take coordinate 0 of those axes
        split = [a for e in self.spec for a in spec_axes(e)]
        parts = parts[tuple(slice(None) if a in split else 0 for a in names)]
        kept = [a for a in names if a in split]
        # full dim i is (its axes, major to minor; the block's dim i)
        order = []
        for i in range(block.dim()):
            axes = spec_axes(self.spec[i]) if i < len(self.spec) else ()
            order += [kept.index(a) for a in axes] + [len(kept) + i]
        return parts.permute(order).reshape(self.full_shape(block.shape))

    def _gather_axes(self, block, axes):
        out = block
        for i, e in enumerate(self.spec):
            split = spec_axes(e)
            take = tuple(a for a in split if a in axes)
            if take != split[len(split) - len(take):]:
                raise ValueError(f"{self.spec}: dim {i} gathers {take} but "
                                 f"keeps a minor axis of {split}")
            for a in reversed(take):
                if self.sizes[a] > 1:
                    out = comm.all_gather(out, self.mesh.get_group(a), dim=i)
        return out

    def placements(self) -> list:
        """DTensor placements, one per mesh dim: ``Shard(i)`` where the
        spec splits tensor dim ``i`` over that mesh dim, else
        ``Replicate()``. A dim split over several mesh dims must name them
        in the mesh's order (DTensor splits left to right)."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.sizes)
        out = [Replicate()] * len(names)
        for i, e in enumerate(self.spec):
            axes = spec_axes(e)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"{self.spec}: dim {i} splits over {axes}, "
                                 f"not in the mesh's order {names}")
            for p in pos:
                out[p] = Shard(i)
        return out


def axes_group(mesh, axes: Sequence[str]):
    """The process group of a DeviceMesh's ranks that differ only on
    ``axes`` and hold this rank's coordinates on the others, numbered
    major to minor over ``axes`` (a dim split over them is split so). It
    makes one group for each coordinate of the other axes, so every rank
    of the mesh calls it, in the same order."""
    import torch.distributed as dist
    names = list(mesh.mesh_dim_names)
    order = [names.index(a) for a in names if a not in axes] + [
        names.index(a) for a in axes]
    n = math.prod(mesh_shape(mesh)[a] for a in axes)
    ranks = mesh.mesh.permute(order).reshape(-1, n).tolist()
    group, _ = dist.new_subgroups_by_enumeration(ranks)
    return group


class TensorParallel(NamedTuple):
    """The ranks that split one layer's compute: the ``model`` axis's
    ``group`` of ``size`` ranks, this rank ``rank`` of them. A product
    whose weight is split over it is Megatron's: column-parallel where the
    weight's output dim is split (the rank's heads, MLP columns, vocabulary
    rows), row-parallel where its input dim is, followed by
    ``comm.all_reduce_sum`` over ``group``."""

    group: object
    size: int
    rank: int

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial ``x``."""
        return comm.all_reduce_sum(x, self.group)

    def splits(self, block: int, full: int) -> bool:
        """Whether a dim of ``full`` entries is split over the ranks, from
        the ``block`` entries this rank holds of it: its ``1/size`` (kept
        split by ``Sharder.use``) or the whole (gathered, or never split).
        Any other block is a layout the model does not know: it
        raises."""
        if block == full:
            return False
        if block * self.size == full:
            return True
        raise ValueError(f"a block of {block} of {full} entries over "
                         f"{self.size} ranks")


class Sharder:
    """Logical-axis specs for a model on a mesh; no-op without one.

    Model code may call ``shd(x, "batch", "seq", "act_heads", None)`` at
    layer boundaries, as the reference pins GSPMD there: on this port a
    rank computes on its own block, so the call returns ``x``. With a
    DeviceMesh (or a ``RankMesh``) the model's tensors are the rank's
    blocks (``local``); the mesh axes its batch rows are split over are
    those of the global batch's spec, which the caller that laid the
    batch out names with :meth:`rank_batch` (all of the ``batch`` rule's
    axes otherwise). Within :meth:`rank_blocks` the parameters are the
    rank's blocks too: :meth:`use` gathers a layer's leaves where the
    layer runs, and :attr:`tp` names the ranks that split its compute.

    ``tp_axes``: the logical axes whose ``model`` split the model's
    compute consumes (none: every layer runs replicated over ``model``);
    ``tp_replicated``: leaf names used whole even so (the MoE router,
    whose softmax spans every expert; mamba2's conv, xlstm's sLSTM
    ``r``)."""

    def __init__(self, mesh=None, rules: Optional[dict] = None,
                 tp_axes: Sequence[str] = (),
                 tp_replicated: Sequence[str] = ()):
        self.mesh = mesh
        self.rules = rules
        self.tp_axes = frozenset(tp_axes)
        self.tp_replicated = frozenset(tp_replicated)
        self._batch_axes = None
        self._blocks = None
        self._groups = {}
        self.cache_specs = None

    @property
    def local(self) -> bool:
        return self.mesh is not None and is_device_mesh(self.mesh)

    def spec(self, logical_axes, shape=None) -> PartitionSpec:
        assert self.mesh is not None
        return spec_for(self.mesh, logical_axes, shape, self.rules)

    def __call__(self, x, *logical_axes):
        return x

    def named(self, spec) -> list:
        """The DTensor placements of ``spec`` on this sharder's mesh."""
        assert self.mesh is not None
        return NamedSharding(self.mesh, spec).placements()

    def batch_axes(self, b: int) -> tuple:
        """The mesh axes a batch of ``b`` rows is split over: the spec of
        ``b`` rows for global tensors; for a rank's rows on a DeviceMesh,
        the global batch's (:meth:`rank_batch`)."""
        if self.mesh is None:
            return ()
        if self.local:
            if self._batch_axes is not None:
                return self._batch_axes
            spec = self.spec(("batch",))
        else:
            spec = self.spec(("batch",), (b,))
        return spec_axes(spec[0]) if len(spec) else ()

    @contextlib.contextmanager
    def rank_batch(self, axes: Sequence[str]):
        """Within the block, the rank's batch rows are its share of a
        global batch split over ``axes``."""
        prev, self._batch_axes = self._batch_axes, tuple(axes)
        try:
            yield self
        finally:
            self._batch_axes = prev

    @contextlib.contextmanager
    def rank_blocks(self, specs, axes, cache_specs=None):
        """Within the block, the parameters the model is given are the
        rank's blocks laid out by ``specs`` (a PartitionSpec tree) from the
        logical ``axes`` tree beside it (``abstract_params``), and so are
        its caches, laid out by ``cache_specs`` (``serve.step.cache_specs``;
        None: no caches, or caches split over the batch only)."""
        prev = self._blocks, self.cache_specs
        self._blocks, self.cache_specs = (specs, axes), cache_specs
        try:
            yield self
        finally:
            self._blocks, self.cache_specs = prev

    @property
    def tp(self) -> Optional[TensorParallel]:
        """The ranks that split a layer's compute, within
        :meth:`rank_blocks` on a mesh whose ``model`` axis holds more than
        one rank and does not split the batch, for a model with
        ``tp_axes``; else None (every product runs whole)."""
        if self._blocks is None or not self.tp_axes:
            return None
        size = mesh_shape(self.mesh).get("model", 1)
        if size == 1 or "model" in self.batch_axes(0):
            return None
        return TensorParallel(self.mesh.get_group("model"), size,
                              self.mesh.get_local_rank("model"))

    def kv_split(self, spec, dim: int = 2) -> Optional[TensorParallel]:
        """The ranks that split a cache leaf's sequence (dim ``dim`` of its
        ``spec``, the ``kv_seq`` axis), within :meth:`rank_blocks`: the
        rank's block of positions is the ``rank``-th of ``size``, over one
        group of every split axis (:func:`axes_group` on a DeviceMesh,
        made once and kept). None where the sequence is whole."""
        if self._blocks is None:
            return None
        sizes = mesh_shape(self.mesh)
        axes = tuple(a for a in (spec_axes(spec[dim]) if len(spec) > dim
                                 else ()) if sizes[a] > 1)
        if not axes:
            return None
        rank = 0
        for a in axes:
            rank = rank * sizes[a] + self.mesh.get_local_rank(a)
        if len(axes) == 1:
            group = self.mesh.get_group(axes[0])
        elif comm.world_group(self.mesh) is not None:
            group = self.mesh.get_group(axes)       # a RankMesh's stand-in
        else:
            if axes not in self._groups:
                self._groups[axes] = axes_group(self.mesh, axes)
            group = self._groups[axes]
        return TensorParallel(group, math.prod(sizes[a] for a in axes),
                              rank)

    def cache_kv_split(self, key=None, dim: int = 2):
        """:meth:`kv_split` of the (k, v) pair at ``key`` of the caches'
        specs (the whole tree for None), within :meth:`rank_blocks` with
        ``cache_specs``; else None."""
        specs = self.cache_specs
        if specs is None:
            return None
        return self.kv_split((specs if key is None else specs[key])[0], dim)

    def use(self, tree, *path, stacked: bool = False):
        """The leaves of ``tree``, the rank's blocks of the parameter
        subtree at ``path`` (one layer's slice of ``[L, ...]`` leaves with
        ``stacked``), as the layer uses them: every split undone but
        ``model``'s on a dim of ``tp_axes`` (``NamedSharding.gather``
        over the rest, whose backward reduce-scatters). ``tree`` itself
        outside :meth:`rank_blocks`."""
        if self._blocks is None:
            return tree
        specs, axes = self._blocks
        for k in path:
            specs, axes = specs[k], axes[k]
        return self._use(tree, specs, axes, stacked, path[-1] if path
                         else None)

    def leaves(self, params, *names) -> dict:
        """The top-level leaves ``names`` of ``params`` as used
        (:meth:`use`)."""
        return {k: self.use(params[k], k) for k in names}

    def _use(self, t, spec, axes, stacked, name):
        if isinstance(t, dict):
            return {k: self._use(t[k], spec[k], axes[k], stacked, k)
                    for k in t}
        if stacked:
            spec, axes = PartitionSpec(*spec[1:]), axes[1:]
        gather = set()
        for i, e in enumerate(spec):
            keep = (e == "model" and axes[i] in self.tp_axes
                    and name not in self.tp_replicated)
            if not keep:
                gather.update(spec_axes(e))
        if not gather:
            return t
        return NamedSharding(self.mesh, spec).gather(t, gather)

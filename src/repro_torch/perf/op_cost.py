"""Op counter: the FLOPs, bytes and live memory of eager PyTorch, op by op
(the port's counterpart of ``repro.perf.hlo_cost``).

The reference walks XLA's optimized HLO and multiplies each while body by
its trip count. The port has no HLO: :class:`OpCounter` is a
``TorchDispatchMode`` that sees every aten op and custom op as it runs, on
the meta device (the dry-run: shapes only, nothing allocated) or on the
card (the same Python on real tensors).

Per op it counts

- FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry: the matmul family, convolutions, attention, and the flash
  kernel's custom op ``repro_torch::flash_fwd``), as ``hlo_cost`` counts
  dots and convolutions only;
- bytes: each tensor input read once and each output written once (an
  eager op really moves them; ``hlo_cost`` counts a fusion's operands and
  result). Views and ops whose output shares an input's storage move
  nothing, nor does an ``empty``; ``copy_`` reads its source and writes its
  destination. The flash op counts q, k, v and o: its scores stay on chip;
- per site (the innermost ``repro_torch`` function that issued the op;
  ``backward:<node>`` in the backward) and per op, for ``perf.diagnose``;
- with ``track_memory``, the live bytes and their peak: every storage an op
  creates is added (rounded up to the CUDA caching allocator's 512-byte
  blocks) and taken away when it is freed; ``track`` adds the step's
  arguments first;
- the collectives the parallel layer's stand-ins report (``collective``).

Trip scaling, ``hlo_cost``'s trip count: with ``scale_loops`` the loops
of ``core.loops`` (``trips``, ``scan``) run only the trips that differ,
each counted as the trips it stands for (see that module). The counter
registers itself there while it runs, which is also where the parallel
layer's stand-in collectives find it.
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import loops

aten = torch.ops.aten

#: the CUDA caching allocator's smallest block: every allocation rounds up
ALLOC_BLOCK = 512
#: allocations that move no bytes
_NO_DATA = {aten.empty.memory_format, aten.empty_like.default,
            aten.empty_strided.default, aten.new_empty.default,
            aten.new_empty_strided.default, aten.detach.default,
            aten.lift_fresh.default}
_ROOT = "repro_torch"
_SELF = __file__


def _tensors(tree, out=None) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """The innermost ``repro_torch`` function (outside this module) on
    the stack, as ``path/file.py:function``; ``backward:<node>`` while
    the autograd engine runs a node."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward:{node.name()}"
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if _ROOT in fn and fn != _SELF:
            rel = fn[fn.rindex(_ROOT) + len(_ROOT) + 1:]
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "other"


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, sites and (with ``track_memory``) live bytes
    of every op run inside ``with OpCounter(...)``; ``scale_loops`` lets
    ``core.loops.trips`` and ``scan`` run only the trips that differ."""

    def __init__(self, *, scale_loops: bool = False,
                 track_memory: bool = False):
        super().__init__()
        self.scale_loops = scale_loops
        self.track_memory = track_memory
        self.flops = 0.0
        self.bytes = 0.0
        self.mult = 1.0
        self.paused = 0
        self.by_site: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
        #: (op, multiplier) -> [flops, bytes, calls]
        self.by_op: Dict[tuple, List[float]] = defaultdict(
            lambda: [0.0, 0.0, 0])
        #: (op, result bytes, group size, crosses pod) -> count
        self.collectives: Dict[tuple, float] = defaultdict(float)
        self.live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_top: List[tuple] = []
        self._snap_at = 0

    # -- the mode -----------------------------------------------------------

    def __enter__(self):
        loops.enter(self)
        return super().__enter__()

    def __exit__(self, *exc):
        loops.leave(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.track_memory:
            for t in _tensors(out):
                self._add(t)
        if self.paused:
            return out
        packet = func._overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out)) * self.mult
        n_bytes = self._bytes(func, args, kwargs, out) * self.mult
        self.flops += flops
        self.bytes += n_bytes
        row = self.by_site[_site()]
        row[0] += flops
        row[1] += n_bytes
        row = self.by_op[(str(packet).split(".")[-1], self.mult)]
        row[0] += flops
        row[1] += n_bytes
        row[2] += 1
        return out

    @staticmethod
    def _bytes(func, args, kwargs, out) -> float:
        if func in _NO_DATA or func.is_view:
            return 0.0
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func is aten.copy_.default:
            return float(_nbytes(args[1]) + _nbytes(args[0]))
        if not func._schema.is_mutable:
            # an output on an input's storage (``_unsafe_view``, ``alias``)
            # is a view: no data moves
            stores = {t.untyped_storage()._cdata for t in ins}
            if outs and all(t.untyped_storage()._cdata in stores
                            for t in outs):
                return 0.0
        return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))

    # -- memory -------------------------------------------------------------

    def track(self, tree):
        """Count the storages of ``tree``'s tensors as live (a step's
        arguments, made before the counter ran)."""
        for t in _tensors(tree):
            self._add(t)

    def _add(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        self.live[key] = (n, tuple(t.shape), str(t.dtype).split(".")[-1],
                          _site())
        weakref.finalize(st, self._free, key)
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            if self.peak_bytes > self._snap_at * 1.005:
                # the largest live tensors near the peak (snapshot every
                # 0.5 % of growth)
                self._snap_at = self.peak_bytes
                self.peak_top = sorted(self.live.values(), reverse=True)[:20]

    def _free(self, key):
        row = self.live.pop(key, None)
        if row is not None:
            self.live_bytes -= row[0]

    @contextlib.contextmanager
    def pause(self):
        """Run ops without counting them (memory is still tracked)."""
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def hold(self, n_bytes: int) -> Optional[torch.Tensor]:
        """A meta block of ``n_bytes`` the tracker counts as live while
        the caller keeps it (None for 0)."""
        if n_bytes <= 0:
            return None
        with self.pause():
            return torch.empty(int(n_bytes), dtype=torch.uint8,
                               device="meta")

    # -- loops and collectives ----------------------------------------------

    @contextlib.contextmanager
    def scaled(self, n: float):
        """Count the ops inside ``n`` times over."""
        prev, self.mult = self.mult, self.mult * n
        try:
            yield
        finally:
            self.mult = prev

    def collective(self, op: str, result_bytes: int, group_size: int,
                   crosses_pod: bool):
        """One collective of ``op`` (``all-gather``, ``all-reduce``,
        ``all-to-all``, ``reduce-scatter``) whose result holds
        ``result_bytes`` a rank, over ``group_size`` ranks; counted as
        often as the enclosing loops run."""
        if not self.paused:
            self.collectives[(op, int(result_bytes), int(group_size),
                              bool(crosses_pod))] += self.mult


def ring_bytes(op: str, result_bytes: float, group_size: int) -> float:
    """Bytes one rank moves over its links for one collective whose result
    holds ``result_bytes``, ring accounting (the reference's
    ``collective_bytes_per_device``): (g-1)/g of the result for an
    all-gather or an all-to-all, twice that for an all-reduce, and (g-1)/g
    of the input, g results, for a reduce-scatter (the collectives the
    port's stand-ins report)."""
    g = max(group_size, 1)
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    return result_bytes * (g - 1) / g * (2 if op == "all-reduce" else 1)

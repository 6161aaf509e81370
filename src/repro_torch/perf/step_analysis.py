"""Per-rank analysis of one counted step: argument bytes from the sharding
specs, the peak live bytes, the collectives' link traffic and the count's
FLOPs and bytes (the port's counterpart of ``repro.perf.hlo_analysis``).

The reference reads a compiled executable: ``memory_analysis()`` for the
argument and temp bytes, the optimized HLO for the collectives. The port
has no executable. Its record comes from the specs and from a
``perf.op_cost.OpCounter`` that ran the rank's step:

- ``argument_bytes``: the rank's blocks of the step's arguments (state,
  batch, caches), from their specs on the mesh (``NamedSharding``:
  each dim divided by the mesh axes it is split over), with no process
  group;
- ``temp_bytes``: the counter's peak live bytes above the arguments;
- ``collectives``: the stand-ins' reports, in the reference's ring
  accounting (``collective_bytes_per_device``), split into NVLink
  (``ici_bytes``) and network (``dcn_bytes``) by whether the group
  crosses the ``pod`` axis;
- ``attn_score_bytes`` and ``f32_hoist_bytes`` are 0: the flash op keeps
  its scores on chip, and there is no XLA:CPU hoist. The keys stay, so
  that ``bench_roofline`` reads both packages' records alike.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec,
                                           spec_axes)
from repro_torch.perf.op_cost import OpCounter, ring_bytes


def block_shape(mesh, spec: PartitionSpec, shape) -> tuple:
    """The shape of one rank's block of a tensor of ``shape`` laid out by
    ``spec`` on ``mesh``."""
    sizes = NamedSharding(mesh, spec).sizes
    out = list(shape)
    for i, e in enumerate(spec):
        out[i] //= math.prod(sizes[a] for a in spec_axes(e))
    return tuple(out)


def rank_bytes(mesh, spec_tree, tree) -> int:
    """Bytes of one rank's blocks of ``tree`` (tensors, meta or not, in
    nested dicts, tuples and NamedTuples) laid out by the matching
    ``spec_tree``."""
    if isinstance(spec_tree, PartitionSpec):
        return math.prod(block_shape(mesh, spec_tree, tree.shape)) \
            * tree.element_size()
    if isinstance(spec_tree, dict):
        return sum(rank_bytes(mesh, spec_tree[k], tree[k]) for k in spec_tree)
    return sum(rank_bytes(mesh, s, t) for s, t in zip(spec_tree, tree))


def collective_bytes_per_device(collectives: Dict[tuple, float]
                                ) -> Dict[str, float]:
    """Per-rank link traffic (bytes) of ``OpCounter.collectives``, ring
    accounting (``op_cost.ring_bytes``), split into NVLink
    (``ici_bytes``) and network (``dcn_bytes``), with each op's total."""
    ici = dcn = 0.0
    per_op: Dict[str, float] = {}
    for (op, result, g, crosses), count in collectives.items():
        b = ring_bytes(op, result, g) * count
        per_op[op] = per_op.get(op, 0.0) + b
        if crosses:
            dcn += b
        else:
            ici += b
    return {"ici_bytes": ici, "dcn_bytes": dcn, **per_op}


def analyze(counter: OpCounter, argument_bytes: int) -> Dict:
    """The record of one counted step (the keys of the reference's
    ``hlo_analysis.analyze``; ``peak_bytes`` beside them)."""
    counts: Dict[str, float] = {}
    for (op, _, _, _), n in counter.collectives.items():
        counts[op] = counts.get(op, 0) + n
    peak = max(counter.peak_bytes, argument_bytes)
    return {
        "flops": counter.flops,
        "bytes_accessed": counter.bytes,
        "attn_score_bytes": 0.0,
        "f32_hoist_bytes": 0.0,
        "collectives": collective_bytes_per_device(counter.collectives),
        "collective_counts": counts,
        "n_collectives": sum(counts.values()),
        "peak_bytes": peak,
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": 0,
            "temp_bytes": peak - argument_bytes,
            "alias_bytes": 0,
            "code_bytes": 0,
        },
    }

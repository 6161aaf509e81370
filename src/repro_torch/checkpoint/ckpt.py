"""Atomic checkpointing of trees of tensors (torch + numpy, no pickle).

Layout: <dir>/step_<n>/
    manifest.json            tree structure, shapes, dtypes, step metadata
    <leaf-path>.bin          one raw-bytes file per leaf (host copy)
    _COMMITTED               atomicity marker (written last)

The layout, the leaf keys (``__``-joined paths: dict keys, NamedTuple field
names, ``idx<i>`` for sequence items) and the dtype names are the
reference's (``repro.checkpoint.ckpt``), so each side reads the other's
checkpoints: a ``TrainState`` is ``params__<...>``, ``opt__m__<...>``,
``opt__v__<...>`` and ``opt__step``. bfloat16 leaves are written and read
through a 16-bit integer view under the dtype name ``bfloat16`` (the
reference reads them with ``ml_dtypes``, which the port does not need).

Fault-tolerance contract: a checkpoint is valid iff _COMMITTED exists;
restore picks the newest valid step; partial writes from a crashed save are
ignored and garbage-collected. Saves can run in a background thread
(``AsyncSaver``) so the train loop overlaps I/O with compute — the paper's
SSD benchmarks (Fig. 9) motivate sizing this I/O.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "__"

#: torch dtype <-> the manifest's (numpy) dtype name
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the order ``_unflatten`` consumes them."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(f"idx{i}", v) for i, v in enumerate(tree)]
    else:
        return [(_SEP.join(prefix), tree)]
    return [kv for name, v in items for kv in _flatten(v, prefix + (name,))]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> torch.Tensor:
    """A host copy of a leaf (a tensor, numpy array or scalar) that later
    in-place updates of the original cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


def _raw(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save(tree, directory, step: int, extra: Optional[Dict] = None) -> pathlib.Path:
    """Atomic synchronous save. Returns the committed directory."""
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": {}}
    for key, leaf in _flatten(tree):
        t = _host(leaf)
        if t.dtype not in _NAMES:
            raise TypeError(f"{key}: no checkpoint dtype for {t.dtype}")
        (tmp / f"{key}.bin").write_bytes(_raw(t))
        manifest["leaves"][key] = {"shape": list(t.shape),
                                   "dtype": _NAMES[t.dtype]}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "_COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


class AsyncSaver:
    """Background-thread checkpointing; at most one save in flight."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[pathlib.Path] = None
        self.error: Optional[BaseException] = None

    def save(self, tree, directory, step, extra=None):
        self.wait()
        # host copies on the caller thread: the train step updates the
        # state's tensors in place afterwards
        leaves = iter([_host(x) for _, x in _flatten(tree)])
        host_tree = _unflatten(tree, leaves)

        def run():
            try:
                self.last_path = save(host_tree, directory, step, extra)
            except BaseException as e:  # noqa: BLE001 (re-raised by wait)
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise self.error


def valid_steps(directory) -> List[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return []
    out = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and (d / "_COMMITTED").exists():
            out.append(int(d.name.split("_")[1]))
    return sorted(out)


def gc_partial(directory):
    """Remove uncommitted (crashed) checkpoint attempts."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return
    for d in directory.iterdir():
        if d.name.startswith(".tmp_step_") or (
                d.name.startswith("step_") and not (d / "_COMMITTED").exists()):
            shutil.rmtree(d)


def restore(tree_like, directory, step: Optional[int] = None,
            device=None, shardings=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``.

    Each leaf comes back as a tensor of the manifest's dtype and shape, on
    ``device``, or where ``device`` is None on the device of the matching
    leaf of ``tree_like`` (the host for a leaf that is not a tensor).

    shardings: optional matching tree of ``NamedSharding``
    (``repro_torch.train.step.shardings``): each leaf comes back as this
    rank's block of the full leaf (every rank reads the full leaf; a
    multi-host deployment would read its blocks)."""
    directory = pathlib.Path(directory)
    steps = valid_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step = step if step is not None else steps[-1]
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out_leaves = []
    shard_flat = (None if shardings is None
                  else iter([sh for _, sh in _flatten(shardings)]))
    for key, like in _flatten(tree_like):
        meta = manifest["leaves"][key]
        dtype = _DTYPES[meta["dtype"]]
        raw = bytearray((d / f"{key}.bin").read_bytes())
        t = torch.frombuffer(raw, dtype=torch.int16 if dtype == torch.bfloat16
                             else dtype) if raw else torch.empty(0, dtype=dtype)
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        t = t.reshape(meta["shape"])
        if shard_flat is not None:
            t = next(shard_flat).block(t)
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out_leaves.append(t.to(dev))
    return _unflatten(tree_like, iter(out_leaves)), manifest


def prune(directory, keep: int = 3):
    directory = pathlib.Path(directory)
    steps = valid_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(directory / f"step_{s:08d}")

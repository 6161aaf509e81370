"""Wrappers for the Hopper STREAM kernels (``csrc/stream.cu``).

Each wrapper checks its inputs, allocates the output, launches its kernel
on the current CUDA stream and counts the launch in ``launches[name]``. A
CPU tensor goes to the plain version in ``ref``; a CUDA tensor goes to the
kernel or raises. ``stream_write``, which takes no tensor, runs where
``device`` says: the CUDA card by default (raising without one), the host
plain version for ``device="cpu"``.

A row count that ``block_rows`` does not divide raises ``ValueError``: the
reference kernels' grid is ``rows // block_rows`` and leaves such a tail
unwritten.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.stream import ref

KERNELS = ("stream_copy", "stream_scale", "stream_add", "stream_triad",
           "stream_write", "stream_read")

#: kernel launches since the last reset, by kernel (callers zero them)
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = {
    "stream_copy": [_P, _P, _L, _I, _P],
    "stream_scale": [_P, _P, _F, _L, _I, _P],
    "stream_add": [_P, _P, _P, _L, _I, _P],
    "stream_triad": [_P, _P, _P, _F, _L, _I, _P],
    "stream_write": [_P, _F, _L, _I, _P],
    "stream_read": [_P, _P, _L, _L, _I, _P],
}


def _kernel(name):
    fn = getattr(build.load("stream"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_rows(shape, block_rows):
    if len(shape) != 2:
        raise ValueError(f"STREAM kernels take a (rows, cols) array, got "
                         f"shape {tuple(shape)}")
    rows, cols = shape
    if rows < 1 or cols < 1 or block_rows < 1:
        raise ValueError(f"empty shape {tuple(shape)} or block_rows "
                         f"{block_rows}")
    block_rows = min(block_rows, rows)
    if rows % block_rows:
        raise ValueError(f"rows {rows} is not a multiple of block_rows "
                         f"{block_rows}")


def _check(arrays: Sequence[torch.Tensor], block_rows) -> bool:
    """Validates the inputs; True when they lie on the host."""
    a = arrays[0]
    _check_rows(a.shape, block_rows)
    for t in arrays:
        if t.shape != a.shape or t.dtype != a.dtype or t.device != a.device:
            raise ValueError("STREAM inputs must share shape, dtype and "
                             "device")
    if a.dtype not in _DTYPES:
        raise TypeError(f"STREAM kernels take {list(_DTYPES)}, got {a.dtype}")
    if a.device.type == "cpu":
        return True
    if a.device.type != "cuda":
        raise ValueError(f"STREAM: no kernel for {a.device}")
    if not all(t.is_contiguous() for t in arrays):
        raise ValueError("STREAM kernels need contiguous inputs")
    return False


def _launch(name, device, *args):
    with torch.cuda.device(device):
        rc = _kernel(name)(*args, torch.cuda.current_stream(device)
                           .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launches[name] += 1


def _scalar(x, dtype) -> float:
    """x rounded to dtype, handed to the kernel as a float."""
    return ref.scalar(x, dtype).item()


def stream_copy(a, *, block_rows=256):
    if _check([a], block_rows):
        return ref.copy(a)
    o = torch.empty_like(a)
    _launch("stream_copy", a.device, a.data_ptr(), o.data_ptr(), a.numel(),
            _DTYPES[a.dtype])
    return o


def stream_scale(a, x, *, block_rows=256):
    if _check([a], block_rows):
        return ref.scale(a, x)
    o = torch.empty_like(a)
    _launch("stream_scale", a.device, a.data_ptr(), o.data_ptr(),
            _scalar(x, a.dtype), a.numel(), _DTYPES[a.dtype])
    return o


def stream_add(a, b, *, block_rows=256):
    if _check([a, b], block_rows):
        return ref.add(a, b)
    o = torch.empty_like(a)
    _launch("stream_add", a.device, a.data_ptr(), b.data_ptr(), o.data_ptr(),
            a.numel(), _DTYPES[a.dtype])
    return o


def stream_triad(a, b, x, *, block_rows=256):
    if _check([a, b], block_rows):
        return ref.triad(a, b, x)
    o = torch.empty_like(a)
    _launch("stream_triad", a.device, a.data_ptr(), b.data_ptr(),
            o.data_ptr(), _scalar(x, a.dtype), a.numel(), _DTYPES[a.dtype])
    return o


def stream_write(shape, x, dtype=torch.float32, *, block_rows=256,
                 device: DeviceLike = None):
    dev = resolve_device(device)
    _check_rows(shape, block_rows)
    if dtype not in _DTYPES:
        raise TypeError(f"STREAM kernels take {list(_DTYPES)}, got {dtype}")
    if dev.type == "cpu":
        return ref.write(shape, x, dtype, dev)
    o = torch.empty(tuple(shape), dtype=dtype, device=dev)
    _launch("stream_write", dev, o.data_ptr(), _scalar(x, dtype), o.numel(),
            _DTYPES[dtype])
    return o


def stream_read(a, *, block_rows=256):
    """One sum per ``block_rows`` rows -> ``[rows/block_rows, 1]`` in a's
    dtype, accumulated in f32."""
    if _check([a], block_rows):
        return ref.read(a, block_rows)
    rows, cols = a.shape
    br = min(block_rows, rows)
    o = torch.empty((rows // br, 1), dtype=a.dtype, device=a.device)
    _launch("stream_read", a.device, a.data_ptr(), o.data_ptr(), rows // br,
            br * cols, _DTYPES[a.dtype])
    return o

"""Plain PyTorch versions of the STREAM kernels (paper Sec. 5.1 semantics).

The wrappers in ``stream`` use them for CPU tensors only; the tests and
``chip_smoke.py`` hold the CUDA kernels against them. As in the reference,
the scalar ``x`` is first rounded to the array's dtype."""
from __future__ import annotations

import torch


def scalar(x: float, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, as ``jnp.asarray(x, dtype)`` rounds it."""
    return torch.tensor(x, dtype=dtype)


def copy(a):
    return a.clone()


def scale(a, x):
    return a * scalar(x, a.dtype).to(a.device)


def add(a, b):
    return a + b


def triad(a, b, x):
    return scalar(x, a.dtype).to(a.device) * a + b


def write(shape, x, dtype=torch.float32, device="cpu"):
    return torch.full(shape, x, dtype=dtype, device=device)


def read(a, block_rows=256):
    """One sum per block of ``block_rows`` rows -> ``[rows/block_rows, 1]``
    in a's dtype (accumulated in f32 for bf16, as ``jnp.sum`` does)."""
    rows, cols = a.shape
    block_rows = min(block_rows, rows)
    return a.reshape(rows // block_rows, block_rows * cols).sum(
        dim=1, keepdim=True)


def read_limit(a, want, block_rows=256):
    """The largest ``|got - want|`` allowed per row block between two
    ``read`` results that sum ``a`` in different orders: ``1e-5 *
    sum(|a|)`` of the block for the f32 summation order, plus, where the
    output is bf16, one bf16 ulp of the sum (``2**-7 * |want|``), since two
    f32 sums that differ may round to neighbouring bf16 values."""
    rows, cols = a.shape
    block_rows = min(block_rows, rows)
    abs_sum = a.float().abs().reshape(rows // block_rows, -1).sum(
        1, keepdim=True)
    rel = 2.0 ** -7 if a.dtype == torch.bfloat16 else 0.0
    return rel * want.float().abs() + 1e-5 * abs_sum

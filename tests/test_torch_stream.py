"""The port's STREAM kernels against the reference.

On the CPU each wrapper runs its kernel's plain version; it is held against
the Pallas TPU kernels (interpret mode) and their oracle over the sweeps of
``tests/test_kernels.py``, on the same inputs made with numpy. Tolerances:
- copy and write, and scale and add in f32, are bitwise equal: each is one
  correctly rounded operation (or none) on both sides;
- f32 triad: rtol 1e-6 and atol 1e-6. The port rounds x*a and then +b;
  the reference compiler contracts them into one FMA and skips the
  product's rounding, so results differ by up to half an ulp of x*a
  (< 2.4e-7 for these |x*a| < 8), large relative to a sum near zero;
- bf16 scale/add/triad: the reference tests' rtol 1e-2 / 2e-2 (atol 1e-2
  for triad): bf16 results may be rounded at other places;
- read: the summation order differs, so the error is bounded per row
  block by ``ref.read_limit``: 1e-5 of sum(|a|) for the f32 order, plus in
  bf16 one bf16 ulp of the sum (2**-7 |want|), as two f32 sums that differ
  may round to neighbouring bf16 values.
The CUDA kernels themselves are held against the plain versions on the
card (``cuda`` marker, ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream import ops as jops
from repro.kernels.stream import ref as jref
from repro.kernels.stream import stream as jk
from repro_torch.kernels.stream import ops, ref, stream

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
I = dict(interpret=True)
SHAPES = [(64, 128), (256, 128), (128, 512)]
X = 1.7


def _pair(rng, shape, dtype):
    """The same values in both frameworks: numpy f64 -> dtype once."""
    j = jnp.asarray(rng.normal(size=shape), JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("rows,cols", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_suite_matches_pallas(rows, cols, dtype):
    rng = np.random.default_rng(0)
    (aj, at), (bj, bt) = (_pair(rng, (rows, cols), dtype) for _ in range(2))
    got = {"copy": stream.stream_copy(at),
           "scale": stream.stream_scale(at, X),
           "add": stream.stream_add(at, bt),
           "triad": stream.stream_triad(at, bt, X)}
    pallas = {"copy": jk.stream_copy(aj, **I),
              "scale": jk.stream_scale(aj, X, **I),
              "add": jk.stream_add(aj, bj, **I),
              "triad": jk.stream_triad(aj, bj, X, **I)}
    oracle = {"copy": jref.copy(aj), "scale": jref.scale(aj, X),
              "add": jref.add(aj, bj), "triad": jref.triad(aj, bj, X)}
    for op, g in got.items():
        assert g.dtype == TDT[dtype] and g.shape == (rows, cols), op
        for want in (pallas[op], oracle[op]):
            if op == "copy" or (dtype == "float32" and op != "triad"):
                np.testing.assert_array_equal(_np(g), _np(want), err_msg=op)
            elif dtype == "float32":
                np.testing.assert_allclose(_np(g), _np(want), rtol=1e-6,
                                           atol=1e-6, err_msg=op)
            elif op == "triad":
                np.testing.assert_allclose(_np(g), _np(want), rtol=2e-2,
                                           atol=1e-2, err_msg=op)
            else:
                np.testing.assert_allclose(_np(g), _np(want), rtol=1e-2,
                                           err_msg=op)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_write_matches_pallas_bitwise(dtype):
    got = stream.stream_write((64, 128), 3.5, TDT[dtype], device="cpu")
    assert got.dtype == TDT[dtype] and got.shape == (64, 128)
    np.testing.assert_array_equal(
        _np(got), _np(jk.stream_write((64, 128), 3.5, JDT[dtype], **I)))
    # an x that bf16 must round: both sides round it the same way
    np.testing.assert_array_equal(
        _np(stream.stream_write((16, 128), X, TDT[dtype], device="cpu")),
        _np(jref.write((16, 128), X, JDT[dtype])))


@pytest.mark.parametrize("rows,cols,block_rows", [
    (64, 128, 16), (256, 128, 256), (128, 512, 256), (256, 128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_read_matches_pallas(rows, cols, block_rows, dtype):
    rng = np.random.default_rng(1)
    aj, at = _pair(rng, (rows, cols), dtype)
    got = stream.stream_read(at, block_rows=block_rows)
    br = min(block_rows, rows)
    assert got.dtype == TDT[dtype] and got.shape == (rows // br, 1)
    for want in (jk.stream_read(aj, block_rows=block_rows, **I),
                 jref.read(aj, block_rows=block_rows)):
        want = torch.tensor(_np(want))
        assert bool(((got.float() - want).abs()
                     <= ref.read_limit(at, want, block_rows)).all())


@pytest.mark.parametrize("wrong", ["zeros", "half_block", "one_row_short"])
@pytest.mark.parametrize("block_rows", [16, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_read_limit_rejects_a_wrong_sum(wrong, block_rows, dtype):
    """The read limit is tight enough to catch a kernel that writes zeros,
    sums half of each row block or misses one row of it, at the bandwidth
    bench's 16 MB shape."""
    a = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4096, 1024)).astype(np.float32)).to(TDT[dtype])
    want = ref.read(a, block_rows)
    blocks = a.reshape(4096 // block_rows, block_rows, 1024).float()
    bad = {"zeros": torch.zeros_like(want.float()),
           "half_block": blocks[:, : block_rows // 2].sum((1, 2)),
           "one_row_short": blocks[:, 1:].sum((1, 2))}[wrong]
    bad = bad.reshape(want.shape).to(want.dtype)
    limit = ref.read_limit(a, want, block_rows)
    assert not bool(((bad.float() - want.float()).abs() <= limit).all())


@pytest.mark.parametrize("op", ["copy", "scale", "add", "triad", "read",
                                "write"])
def test_ragged_rows_raise_where_the_reference_writes_nothing(op):
    a = torch.zeros(300, 128)
    call = {"copy": lambda: stream.stream_copy(a),
            "scale": lambda: stream.stream_scale(a, X),
            "add": lambda: stream.stream_add(a, a),
            "triad": lambda: stream.stream_triad(a, a, X),
            "read": lambda: stream.stream_read(a),
            "write": lambda: stream.stream_write((300, 128), X,
                                                 device="cpu")}[op]
    with pytest.raises(ValueError, match="block_rows"):
        call()
    # the rows that block_rows divides are fine
    stream.stream_copy(a[:256])


def test_reference_ragged_tail_fault_is_real():
    """The reference's grid is rows // block_rows: a (300, 128) read sums
    the first 256 rows only (the fault filed in ROADMAP Queue 3)."""
    a = np.ones((300, 128), np.float32)
    out = np.asarray(jk.stream_read(jnp.asarray(a), **I))
    assert out.shape == (1, 1) and out[0, 0] == 256 * 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["read", "write", "copy", "scale", "add",
                                "triad"])
def test_bytes_moved_matches_the_reference(op, dtype):
    aj, at = _pair(np.random.default_rng(2), (64, 128), dtype)
    assert ops.bytes_moved(op, at) == jops.bytes_moved(op, aj)


def test_one_compile_per_new_signature_like_the_reference():
    rng = np.random.default_rng(3)
    (a1j, a1t), (b1j, b1t) = (_pair(rng, (24, 40), "float32")
                              for _ in range(2))
    a2j, a2t = _pair(rng, (48, 40), "float32")
    a3j, a3t = _pair(rng, (24, 40), "bfloat16")
    calls = [("copy", (a1t,), (a1j,)), ("copy", (a1t,), (a1j,)),
             ("copy", (a2t,), (a2j,)), ("copy", (a3t,), (a3j,)),
             ("scale", (a1t, 1.7), (a1j, 1.7)),
             ("scale", (a1t, 2.5), (a1j, 2.5)),
             ("add", (a1t, b1t), (a1j, b1j)),
             ("triad", (a1t, b1t, 1.7), (a1j, b1j, 1.7)),
             ("triad", (a1t, b1t, 0.5), (a1j, b1j, 0.5))]
    names = [f"stream/{op}" for op in ("copy", "scale", "add", "triad")]
    before_t = {n: ops.stats.compiles(n) for n in names}
    before_j = {n: jops.stats.compiles(n) for n in names}
    for op, targs, jargs in calls:
        getattr(ops, op)(*targs)
        getattr(jops, op)(*jargs, interpret=True)
    got = {n: ops.stats.compiles(n) - before_t[n] for n in names}
    want = {n: jops.stats.compiles(n) - before_j[n] for n in names}
    assert got == want == {"stream/copy": 3, "stream/scale": 1,
                           "stream/add": 1, "stream/triad": 1}


def test_cpu_path_is_the_plain_version_and_not_counted():
    a = torch.from_numpy(np.random.default_rng(4).normal(
        size=(32, 64)).astype(np.float32))
    before = dict(stream.launches)
    assert torch.equal(stream.stream_triad(a, a, X), ref.triad(a, a, X))
    assert torch.equal(stream.stream_read(a, block_rows=8),
                       ref.read(a, block_rows=8))
    assert stream.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, b = torch.zeros(16, 32), torch.zeros(16, 32)
    if bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "shape":
        b = torch.zeros(16, 16)
    elif bad == "rank":
        a = b = torch.zeros(16)
    elif bad == "device":
        # neither the host nor a CUDA card: no plain-version fallback
        a, b = a.to("meta"), b.to("meta")
    with pytest.raises((TypeError, ValueError)):
        stream.stream_add(a, b)


def test_write_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.stream_write((8, 8), 1.0)

"""Wrapper for the Hopper dot-product-accumulate matmul
(``csrc/dpa_matmul.cu``).

``dpa_matmul`` casts its inputs as the reference does (``dpa_matmul.py:
49-60``), checks the reference's block divisibility (raising
``ValueError`` where the reference asserts), picks the kernel's route and
tile with ``plan`` from the shape alone, and hands them to ``launch``,
which allocates the output (and for dpa4 on wgmma the ``[N,K]`` scratch
that its transpose kernel fills with B^T), launches the kernel on the
current CUDA stream with one C call and counts the launch in
``launches[variant]`` and ``route_launches["variant/route"]``. A CPU
tensor goes to the plain version
(``ref.matmul``); a CUDA tensor goes to the kernel or raises. The block
sizes are the reference's TPU tiling: they only decide which shapes are
accepted, the kernel tiles by ``plan``'s sizes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dpa_matmul import ref

#: (input dtype, output dtype, kernel code) of each variant
VARIANTS = {
    "fma_f32": (torch.float32, torch.float32, 0),
    "dpa2": (torch.bfloat16, torch.float32, 1),
    "dpa4": (torch.int8, torch.int32, 2),
}

#: the kernel's routes and their codes: FFMA tiles on the CUDA cores,
#: mma.sync, wgmma fed by a TMA ring
ROUTE_CODES = {"ffma": 0, "mma": 1, "wgmma": 2}
#: the routes each variant may take; dpa2 and dpa4 take mma only where TMA
#: cannot describe their operands (``tma_ok``)
ROUTES = {"fma_f32": ("ffma",), "dpa2": ("wgmma", "mma"),
          "dpa4": ("wgmma", "mma")}
#: (block_m, block_n) tiles the kernel has for each route, largest first
TILES = {"ffma": ((128, 128), (64, 64)),
         "mma": ((128, 128),),
         "wgmma": ((128, 256), (64, 64))}

#: kernel launches since the last reset, by variant (callers zero them)
launches: Dict[str, int] = dict.fromkeys(VARIANTS, 0)
#: the same launches by "variant/route"
route_launches: Dict[str, int] = {f"{v}/{r}": 0 for v, rs in ROUTES.items()
                                  for r in rs}
#: launches of the int8 transpose kernel: one with every dpa4 launch on
#: wgmma, one with every ``transpose_int8`` call
transposes: Dict[str, int] = {"launches": 0}


def tma_ok(n: int, k: int, variant: str) -> bool:
    """Whether TMA can describe the wgmma route's operands of ``variant``:
    each row's byte stride a multiple of 16 (``launch`` makes the bases
    16-byte aligned). dpa2 reads bf16 A [M,K] and B [K,N]; dpa4 reads int8
    A [M,K] and B^T [N,K], which its transpose writes (any N)."""
    if variant == "dpa4":
        return k % 16 == 0
    return (2 * k) % 16 == 0 and (2 * n) % 16 == 0


def plan(m: int, n: int, k: int, variant: str,
         sm_count: int) -> Tuple[str, int, int]:
    """(route, block_m, block_n) of the kernel for C[m,n] = A[m,k] @ B[k,n].

    The route follows the variant and the shape: fma_f32 -> ffma; dpa2 and
    dpa4 -> wgmma where ``tma_ok(n, k, variant)``, else mma. The tile is
    the largest of the route's ``TILES`` whose grid has at least
    ``sm_count`` blocks, else the route's smallest (the most blocks)."""
    if variant in ("dpa2", "dpa4"):
        route = "wgmma" if tma_ok(n, k, variant) else "mma"
    elif variant in ROUTES:
        route = ROUTES[variant][0]
    else:
        raise ValueError(variant)
    tiles = TILES[route]
    for bm, bn in tiles:
        if -(-m // bm) * -(-n // bn) >= sm_count:
            return route, bm, bn
    return (route, *tiles[-1])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel():
    fn = build.load("dpa_matmul").dpa_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def kernel_attributes(variant: str, route: str, bm: int,
                      bn: int) -> Dict[str, int]:
    """What the compiler gave the kernel of (variant, route, tile):
    registers and local (spill) bytes a thread, static shared bytes, the
    dynamic shared bytes a launch asks, threads a block."""
    fn = build.load("dpa_matmul").dpa_matmul_attributes
    out = (ctypes.c_int * 5)()
    rc = fn(ctypes.c_int(VARIANTS[variant][2]),
            ctypes.c_int(ROUTE_CODES[route]), ctypes.c_int(bm),
            ctypes.c_int(bn), out)
    if rc != 0:
        raise RuntimeError(f"dpa_matmul_attributes failed: cudaError {rc}")
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem",
                     "threads"), out))


def _dims(a, b):
    """(M, K, N) of a [M,K] @ b [K,N] on one device, else ValueError."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"dpa_matmul takes [M,K] @ [K,N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    return a.shape[0], a.shape[1], b.shape[1]


def _aligned(t):
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dpa_matmul(a, b, *, variant="dpa2", block_m=128, block_n=128,
               block_k=256):
    """a: [M,K], b: [K,N] -> [M,N] in the accumulator dtype.

    variant: fma_f32 | dpa2 (bf16) | dpa4 (int8)."""
    if variant not in VARIANTS:
        raise ValueError(variant)
    m, k, n = _dims(a, b)
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(f"shape (M {m}, N {n}, K {k}) is not a multiple of "
                         f"the blocks ({bm}, {bn}, {bk})")
    if a.device.type == "cpu":
        return ref.matmul(a, b, variant)
    if a.device.type != "cuda":
        raise ValueError(f"dpa_matmul: no kernel for {a.device}")
    index = a.device.index
    if index is None:
        index = torch.cuda.current_device()
    return launch(a, b, variant, *plan(m, n, k, variant, _sm_count(index)))


def launch(a, b, variant, route, bm, bn):
    """The kernel of ``route`` with a ``bm`` x ``bn`` tile on CUDA tensors
    a [M,K] and b [K,N], cast to the variant's input type; counts the
    launch. ``dpa_matmul`` calls it with ``plan``'s choice; the card's
    tests call it with every tile. Raises where the kernel refuses the
    plan or the launch fails, and with ValueError where a and b are not
    [M,K] and [K,N] CUDA tensors of one device or the variant, route or
    tile is unknown."""
    m, k, n = _dims(a, b)
    if variant not in VARIANTS or route not in ROUTES[variant] or (
            bm, bn) not in TILES[route]:
        raise ValueError(f"dpa_matmul has no kernel for {variant} on route "
                         f"{route} with a {bm}x{bn} tile")
    if a.device.type != "cuda":
        raise ValueError(f"dpa_matmul: no kernel for {a.device}")
    in_dtype, out_dtype, code = VARIANTS[variant]
    a = _aligned(a.to(in_dtype).contiguous())
    b = _aligned(b.to(in_dtype).contiguous())
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    # dpa4 on wgmma: B^T, which the C call writes before the product
    transposed = variant == "dpa4" and route == "wgmma"
    scratch = (torch.empty((n, k), dtype=torch.int8, device=a.device)
               if transposed else None)
    with torch.cuda.device(a.device):
        rc = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       code, ROUTE_CODES[route], bm, bn,
                       scratch.data_ptr() if transposed else None,
                       torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dpa_matmul kernel launch failed ({variant}, "
                           f"{route} {bm}x{bn}, M {m} N {n} K {k}): "
                           f"cudaError {rc}")
    launches[variant] += 1
    route_launches[f"{variant}/{route}"] += 1
    if transposed:
        transposes["launches"] += 1
    return out


def transpose_int8(b):
    """int8 b [K,N] -> [N,K] by the transpose kernel that dpa4's wgmma
    route runs before its product (K a multiple of 16); counts the launch
    in ``transposes``. A CPU tensor goes to the plain version,
    ``b.t().contiguous()``."""
    if b.dim() != 2 or b.dtype != torch.int8:
        raise ValueError(f"transpose_int8 takes an int8 [K,N] matrix, got "
                         f"{b.dtype} {tuple(b.shape)}")
    if b.device.type == "cpu":
        return b.t().contiguous()
    if b.device.type != "cuda":
        raise ValueError(f"transpose_int8: no kernel for {b.device}")
    k, n = b.shape
    b = b.contiguous()
    out = torch.empty((n, k), dtype=torch.int8, device=b.device)
    fn = build.load("dpa_matmul").dpa_transpose_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(b.device):
        rc = fn(b.data_ptr(), out.data_ptr(), k, n,
                torch.cuda.current_stream(b.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"transpose_int8 launch failed (K {k} N {n}): "
                           f"cudaError {rc}")
    transposes["launches"] += 1
    return out

"""Build a CUDA source of ``repro_torch/csrc`` into a shared library and load
it with ``ctypes``.

Each source is compiled by ``nvcc`` for ``sm_90a`` at its first use, into
``build/`` at the repository root, under a name keyed by a hash of the
source, of the headers it includes by a quoted name (``csrc/sm90.cuh``) and
of the flags: an edited source or header builds anew, an unchanged one
loads the library already built. The library exposes a plain C interface, so no
PyTorch header is compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(path: pathlib.Path) -> List[pathlib.Path]:
    """``path`` and every header it includes by a quoted name that lies
    beside the including file, recursively, each once, in the order
    first reached."""
    found: List[pathlib.Path] = []
    todo = [path]
    while todo:
        p = todo.pop(0)
        if p in found:
            continue
        found.append(p)
        names = _INCLUDE.findall(p.read_bytes())
        todo += [p.parent / n.decode() for n in names
                 if (p.parent / n.decode()).is_file()]
    return found


def library_path(name: str, src_dir: pathlib.Path = CSRC) -> pathlib.Path:
    """The library of ``<src_dir>/<name>.cu``, named by a hash of the
    source, its headers (``sources``) and the flags."""
    text = b"".join(p.read_bytes() for p in sources(src_dir / f"{name}.cu"))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, src_dir: pathlib.Path = CSRC) -> pathlib.Path:
    """Compile ``<src_dir>/<name>.cu`` (``csrc`` by default) unless its
    library is already built; returns the library's path."""
    out = library_path(name, src_dir)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(src_dir / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib

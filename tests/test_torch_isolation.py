"""The port stands alone: it imports neither jax nor anything of the JAX
package ``repro``, and its entry points never fall back to the host when
no CUDA device is there and none was asked for."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods and len(mods) > 25
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ,
                                   PYTHONPATH=str(REPO / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import_in_source(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_init_without_device_raises_on_a_host_without_cuda(
        monkeypatch):
    _no_cuda(monkeypatch)
    model = build_model(configs.get_smoke("granite-20b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({})
    # asking for the host is explicit and works
    assert model.init(torch.Generator(), "cpu")["embedding"].device.type \
        == "cpu"


def test_cli_without_device_raises_on_a_host_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke", "--requests", "1"])

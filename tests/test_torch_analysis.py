"""The port's dalek-lint (``repro_torch.analysis``) against the reference's
(``repro.analysis``).

- Fixture trios: a positive, a pragma-suppressed and a clean case for
  each rule, in torch idiom, as ``tests/test_analysis.py`` has them.
- Parity on the rules that do not depend on the framework (DLK005-DLK008,
  DLK011, DLK012): the same ``(code, line, col, message, suppressed)``
  from both linters on the same sources, per file and over the repo in
  project mode.
- Parity on the retargeted rules (DLK001-DLK004, DLK009, DLK010): a torch
  translation of each of the reference's JAX fixtures, line for line,
  gets the same active codes on the same lines; the port's own
  ``models/xlstm.py`` ``_causal_conv`` without its pin is flagged DLK010.
  Where a JAX check has no counterpart in ``counting_call`` (argnums,
  donation), a test pins that the port's rule stays silent.
- The port is clean under its own linter, per file and in project mode,
  with the (empty) checked-in baseline; the CLI's exit codes, gate rows,
  determinism and baseline round trip.
"""
import contextlib
import inspect
import io
import json
import os
import re
import textwrap
from pathlib import Path

import pytest

from repro import analysis as janalysis
from repro.analysis.cli import gate_rows as jgate_rows
from repro_torch.analysis import (ProjectIndex, analyze_paths,
                                  analyze_project, analyze_source,
                                  rule_codes)
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.cli import default_paths, gate_rows
from repro_torch.analysis.cli import main as cli_main
from repro_torch.benchmarks import regression_gate
from repro_torch.core import tracing

REPO = Path(__file__).resolve().parent.parent

#: rules that read no framework API: both linters must agree exactly
SHARED = ("DLK005", "DLK006", "DLK007", "DLK008", "DLK011", "DLK012")
#: rules retargeted from jax to torch
RETARGETED = ("DLK001", "DLK002", "DLK003", "DLK004", "DLK009", "DLK010")


def lint(code, path="mod.py", **kw):
    return analyze_source(textwrap.dedent(code), path, **kw)


def jlint(code, path="mod.py"):
    return janalysis.analyze_source(textwrap.dedent(code), path)


def active(findings, code=None):
    return [f for f in findings if f.active
            and (code is None or f.code == code)]


def codes(findings):
    return sorted({f.code for f in findings if f.active})


def rows(findings, only):
    return [(f.code, f.line, f.col, f.message, f.suppressed)
            for f in findings if f.code in only]


def lines(findings, only=RETARGETED):
    return sorted({(f.code, f.line) for f in findings
                   if f.active and f.code in only})


# -- DLK001 bare-compile -------------------------------------------------------


def test_bare_compile_call_and_decorators_flagged():
    fs = lint("""
        import torch
        step = torch.compile(lambda x: x)

        @torch.compile
        def f(x):
            return x

        @torch.jit.script
        def g(x):
            return x
        h = torch.jit.trace(f, (torch.ones(2),))
    """)
    assert [f.line for f in active(fs, "DLK001")] == [3, 5, 9, 12]


@pytest.mark.parametrize("src", [
    "g = torch.cuda.CUDAGraph()",
    "with torch.cuda.graph(g):\n    y = f(x)",
    "f2 = torch.cuda.make_graphed_callables(f, (x,))",
    "from torch.cuda import graph\nwith graph(g):\n    y = f(x)",
    "from torch import compile as tc\nf2 = tc(f)",
])
def test_bare_compile_capture_forms_flagged(src):
    fs = lint("import torch\n" + src + "\n")
    assert codes(fs) == ["DLK001"]


def test_bare_compile_inside_counting_call_or_tracing_clean():
    fs = lint("""
        import torch
        from repro_torch.core.tracing import counting_call

        def step(x):
            return x
        f = counting_call(torch.compile(step), "step")
        g = counting_call(step, "g")
    """)
    assert active(fs) == []
    # a function of core/tracing.py may build them (the sanctioned home
    # of a counted capture); module level there may not
    src = """
        import torch

        def counted_graph(fn):
            return torch.cuda.CUDAGraph()
    """
    assert active(lint(src, path="src/repro_torch/core/tracing.py")) == []
    assert codes(lint(src, path="src/repro_torch/core/other.py")) \
        == ["DLK001"]


def test_bare_compile_suppressed_and_skips_tests():
    fs = lint("""
        import torch
        f = torch.compile(lambda x: x)  # dalek: allow[bare-compile] fixture
    """)
    assert active(fs) == [] and any(f.suppressed for f in fs)
    assert active(lint("""
        import torch
        f = torch.compile(lambda x: x)
    """, path="tests/test_x.py")) == []


# -- DLK002 host-sync ------------------------------------------------------------

HOT_LOOP = """
    import torch
    import numpy as np
    step = counting_call(lambda x: x, "step")

    def drive(x, stream):
        for _ in range(8):
            x = step(x)
            {sync}
        return x
"""


@pytest.mark.parametrize("sync", [
    "h = x.item()", "h = x.tolist()", "h = x.cpu()", "h = x.numpy()",
    'h = x.to("cpu")', 'h = x.to(device="cpu")',
    'h = x.to(torch.device("cpu"))', "h = int(x)", "h = float(x)",
    "h = bool(x)", "h = np.asarray(x)", "h = np.array(x)",
    "h = float(x.cpu().numpy()[0])", "torch.cuda.synchronize()",
    "stream.synchronize()",
])
def test_host_sync_in_loop_flagged(sync):
    fs = lint(HOT_LOOP.format(sync=sync))
    assert codes(fs) == ["DLK002"]
    assert active(fs)[0].line == 9


def test_host_sync_on_host_value_clean():
    # .numpy() on a host-side value (the prompt) is not a device sync
    fs = lint("""
        import torch
        step = counting_call(lambda x: x, "step")

        def drive(reqs):
            for r in reqs:
                p = torch.as_tensor(r).numpy()
                y = step(p)
            return y
    """)
    assert active(fs, "DLK002") == []


def test_host_sync_outside_loop_or_in_a_function_without_steps_clean():
    fs = lint("""
        import torch
        step = counting_call(lambda x: x, "step")

        def drive(x):
            y = step(x)
            torch.cuda.synchronize()
            return y.cpu().numpy()

        def timing(fn, n):
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
    """)
    assert active(fs, "DLK002") == []


def test_host_sync_cleared_by_assigning_the_host_copy():
    fs = lint("""
        step = counting_call(lambda x: x, "step")

        def drive(x):
            for _ in range(8):
                x = step(x)
                h = x.cpu().numpy()  # dalek: allow[host-sync] the one fetch
                tok = int(h[0, 0])
            return tok
    """)
    assert active(fs, "DLK002") == []
    assert [f.line for f in fs if f.suppressed] == [7]


def test_host_sync_through_a_factory_step():
    fs = lint("""
        def make_decode_step(model):
            def decode_step(params, tokens):
                return model(params, tokens)
            return decode_step

        def drive(params, tokens):
            for _ in range(8):
                tokens = decode_step(params, tokens)
                print(tokens.tolist())
    """)
    assert [f.line for f in active(fs, "DLK002")] == [10]


def test_host_sync_suppressed():
    fs = lint(HOT_LOOP.format(
        sync="h = x.cpu().numpy()  # dalek: allow[host-sync] designed fetch"))
    assert active(fs) == [] and any(
        f.suppressed and f.code == "DLK002" for f in fs)


# -- DLK003 device-branch --------------------------------------------------------


def test_device_branch_flagged():
    fs = lint("""
        import torch

        def step(x):
            if x.sum() > 0:
                return x
            return -x
        f = counting_call(step, "step")
    """)
    assert [f.line for f in active(fs, "DLK003")] == [5]


def test_device_branch_via_factory_ternary_and_assert():
    fs = lint("""
        def make_step(scale):
            def step(x, pos):
                while x.max() < scale:
                    x = x * 2
                y = x if pos > 0 else -x
                return y
            return step

        def body(x):
            m = x.abs().max()
            assert m > 0
            return x
        g = counting_call(body, "body")
    """)
    assert [f.line for f in active(fs, "DLK003")] == [4, 6, 12]


def test_device_branch_host_params_and_metadata_clean():
    fs = lint("""
        def step(x, n: int, key=None, greedy: bool = True):
            if n > 2:                      # a host int: fine
                x = x + 1
            if key is None:                # identity test: fine
                x = x + 2
            if x.ndim == 2 and x.shape[0] > 1:   # metadata: fine
                x = x + 3
            b = x.size(0)
            if b > 4 or x.numel() > 8 or x.device.type == "cuda":
                x = x + 4
            if x.dtype == torch.float32 and greedy:
                x = x.float()
            return x
        f = counting_call(step, "step")
    """)
    assert active(fs) == []


def test_device_branch_pragma_header_only():
    body = """
        def step(x):
            y = x.sum()
            if y > 0:{header}
                z = 1{inner}
            return y
        f = counting_call(step, "step")
    """
    fs = lint(body.format(
        header="", inner="  # dalek: allow[device-branch] not the if"))
    assert len(active(fs, "DLK003")) == 1
    fs = lint(body.format(
        header="  # dalek: allow[device-branch] fixture", inner=""))
    assert active(fs, "DLK003") == [] and any(f.suppressed for f in fs)


# -- DLK004 step-kwargs ----------------------------------------------------------


def test_step_kwargs_name_and_extra_keywords_flagged():
    fs = lint("""
        def f(a, b):
            return a + b
        g = counting_call(f, f"step-{a}")
        h = counting_call(f)
        k = counting_call(f, "k", static_argnums=(1,))
        m = counting_call(f, name="m", donate_argnums=(0,))
    """)
    act = active(fs, "DLK004")
    assert [f.line for f in act] == [4, 5, 6, 7]
    assert "literal name" in act[0].message
    assert "static_argnums" in act[2].message
    assert "donate_argnums" in act[3].message


@pytest.mark.parametrize("arg", [
    "np.asarray(pos)", "pos.numpy()", "pos.cpu().numpy()", "pos.tolist()",
    "np.int32(3)", "host",
])
def test_step_kwargs_array_shaped_argument_flagged(arg):
    fs = lint(f"""
        import numpy as np
        step = counting_call(lambda x, p: x, "step")

        def drive(x, pos):
            host = np.arange(4)
            return step(x, {arg})
    """)
    act = active(fs, "DLK004")
    assert [f.line for f in act] == [7] and "array-shaped" in act[0].message


def test_step_kwargs_clean():
    fs = lint("""
        import numpy as np
        import torch
        step = counting_call(lambda x, p, n: x, "step")

        def drive(x, pos):
            host = np.arange(4)
            host = torch.from_numpy(host)
            return step(x, pos, int(pos.shape[0])) + step(x, host, 4)
    """)
    assert active(fs, "DLK004") == []


def test_step_kwargs_suppressed():
    fs = lint("""
        def f(a):
            return a
        # dalek: allow[step-kwargs] one counter a cell by design
        g = counting_call(f, f"cell-{a}")
    """)
    assert active(fs) == [] and any(
        f.suppressed and f.code == "DLK004" for f in fs)


def test_counting_call_has_no_argnums_or_donation():
    """What the JAX rule's argnums and donation checks guard does not exist
    in ``counting_call``: no static or donated arguments (every non-tensor
    argument is static by value), so the port's rule has no such check."""
    assert list(inspect.signature(tracing.counting_call).parameters) \
        == ["fn", "name", "stats", "on_compile"]
    # the reference's use-after-donate and array-shaped-static fixtures,
    # translated without the jax-only keywords: nothing to flag in torch
    jax_src = """
        import jax
        def f(state, batch):
            return state
        step = jax.jit(f, donate_argnums=(0,))  # dalek: allow[bare-jit] fixture

        def drive(state, batch):
            out = step(state, batch)
            return state.params        # donated buffer read again

        def h(x, w):
            return x @ w.T
        k = jax.jit(h, static_argnames=("w",))  # dalek: allow[bare-jit] fixture
    """
    torch_src = """
        import torch
        def f(state, batch):
            return state
        step = counting_call(f, "step")

        def drive(state, batch):
            out = step(state, batch)
            return state.params        # eager: nothing was donated

        def h(x, w):
            return x @ w.T
        k = counting_call(h, "k")
    """
    assert lines(jlint(jax_src)) == [("DLK004", 9), ("DLK004", 12)]
    assert lines(lint(torch_src)) == []


# -- DLK005-DLK008, DLK011, DLK012: the rules that do not depend on the
# framework, as tests/test_analysis.py's fixtures. Each case: (code, source,
# expected), expected "active" (at least one active finding of the code),
# "suppressed" (none active, one suppressed) or "clean" (none).

SHARED_CASES = [
    ("DLK005", """
        from repro_torch.telemetry.session import MonitorSession
        session = MonitorSession(None)
        session.sample(0.1)
    """, "active"),
    ("DLK005", """
        from repro_torch.train.loop import make_session
        session, power = make_session()
        session.sample(0.1)  # dalek: allow[untagged-energy] fixture
    """, "suppressed"),
    ("DLK005", """
        from repro_torch.telemetry.session import MonitorSession
        session = MonitorSession(None)
        session.sample(0.1, tags=("prefill",))
        with session.region("train_step"):
            session.sample(0.2)
    """, "clean"),
    ("DLK006", """
        def a(pool):
            pool.alloc()               # result dropped

        def leaky(self, pool, full):
            blk = pool.alloc()
            if full:
                return None            # leaks blk
            self.table.append(blk)
    """, "active"),
    ("DLK006", """
        def a(pool):
            pool.alloc()  # dalek: allow[refcount-pairing] fixture
    """, "suppressed"),
    ("DLK006", """
        def map_shared(self, slot, blocks):
            for j, blk in enumerate(blocks):
                self.pool.retain(blk)
                self.tables[slot, j] = blk

        def grow(self, slot):
            blk = self.pages.alloc()
            if blk is None:
                return False
            self.tables[slot].append(blk)
            return True
    """, "clean"),
    ("DLK007", """
        def a(tracer):
            tracer.span("prefill")             # result dropped

        def b(tracer):
            sp = tracer.begin("queued")        # never ended here
            sp.set("x", 1)

        class Engine:
            def open(self):
                self._sp = self.tracer.begin("epoch")
    """, "active"),
    ("DLK007", """
        def a(tracer):
            tracer.span("x")  # dalek: allow[unclosed-span] fixture
    """, "suppressed"),
    ("DLK007", """
        import contextlib

        def w(tracer, x):
            with tracer.span("prefill", bucket=8) as sp:
                sp.set("window", 3)
            return x

        def guarded(tracer):
            cm = (tracer.span("step") if tracer is not None
                  else contextlib.nullcontext())
            with cm as sp:
                pass

        def handle(tracer):
            sp = tracer.begin("queued")
            sp.end()

        def transfer(tracer):
            return tracer.begin("handed-off")
    """, "clean"),
    ("DLK008", """
        class Engine:
            def finish(self, slot):
                self.slots.release(slot)
    """, "active"),
    ("DLK008", """
        def finish(slots, slot):
            slots.release(slot)  # dalek: allow[state-reset-pairing] fixture
    """, "suppressed"),
    ("DLK008", """
        class Engine:
            def finish(self, slot):
                self.adapter.free_slot(slot.index)
                self.slots.release(slot)

        class SlotManager:
            def release(self, slot):
                slot.req = None
    """, "clean"),
    ("DLK011", """
        def annotate(sp):
            sp.args["x"] = 1

        def run(tracer, pool):
            sp = tracer.begin("step")
            annotate(sp)
            blk = pool.alloc()
            print_block(blk)

        def print_block(blk):
            print(blk.idx)
    """, "active"),
    ("DLK011", """
        def peek(blk):
            print(blk.idx)

        def run(pool):
            blk = pool.alloc()
            peek(blk)  # dalek: allow[ownership-handoff] fixture
    """, "suppressed"),
    ("DLK011", """
        class Holder:
            def sink(self, blk):
                blk.free()

            def run(self, pool):
                blk = pool.alloc()
                self.sink(blk)

        def peek(blk):
            print(blk.idx)

        def run(pool):
            blk = pool.alloc()
            peek(blk)
            pool.free(blk)
    """, "clean"),
    ("DLK012", """
        import threading

        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self._events = []

            def push(self, e):
                with self._lock:
                    self._events.append(e)

            def drain(self):
                return list(self._events)
    """, "active"),
    ("DLK012", """
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def inc(self):
                with self._lock:
                    self._n += 1

            def read(self):
                return self._n  # dalek: allow[unguarded-shared-state] demo
    """, "suppressed"),
    ("DLK012", """
        import threading

        class Bus:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0
                self._slots = {}

            def _compile_locked(self):
                self._slots["a"] = 1

            def _bump(self):
                self._n += 1

            def inc(self):
                with self._lock:
                    self._bump()
                    self._compile_locked()
    """, "clean"),
]


def _shared_id(case):
    return f"{case[0]}-{case[2]}"


@pytest.mark.parametrize("code,src,want", SHARED_CASES,
                         ids=[_shared_id(c) for c in SHARED_CASES])
def test_shared_rule_trio(code, src, want):
    fs = [f for f in lint(src) if f.code == code]
    act = [f for f in fs if f.active]
    if want == "active":
        assert act
    elif want == "suppressed":
        assert act == [] and any(f.suppressed for f in fs)
    else:
        assert fs == []


@pytest.mark.parametrize("code,src,want", SHARED_CASES,
                         ids=[_shared_id(c) for c in SHARED_CASES])
def test_shared_rule_parity_with_reference(code, src, want):
    assert rows(lint(src), SHARED) == rows(jlint(src), SHARED)


def test_shared_rules_skip_tests_like_the_reference():
    src = """
        def a(tracer):
            tracer.span("x")

        def b(slots, slot):
            slots.release(slot)
    """
    for path in ("tests/test_x.py", "mod.py"):
        assert rows(lint(src, path), SHARED) == rows(jlint(src, path), SHARED)


def test_shared_rules_cross_module_parity(tmp_path):
    (tmp_path / "inspect_util.py").write_text(textwrap.dedent("""
        def peek(blk):
            print(blk.idx)
    """))
    (tmp_path / "runner.py").write_text(textwrap.dedent("""
        from inspect_util import peek

        def run(pool):
            blk = pool.alloc()
            peek(blk)
    """))
    ours = analyze_project([str(tmp_path)])
    theirs = janalysis.analyze_project([str(tmp_path)])
    assert [f.code for f in ours if f.active] == ["DLK011"]
    assert rows(ours, SHARED) == rows(theirs, SHARED)


def test_shared_rules_project_parity_over_the_repo():
    """The reference's CI invocation (``src benchmarks examples tests``)
    through both linters, restricted to the shared rules: the same list."""
    paths = [str(REPO / p) for p in ("src", "benchmarks", "examples",
                                     "tests")]
    ours = analyze_project(paths, select=list(SHARED))
    theirs = janalysis.analyze_project(paths, select=list(SHARED))
    assert [(f.path,) + r for f, r in zip(ours, rows(ours, SHARED + (
        "DLK000",)))] == [(f.path,) + r for f, r in zip(theirs, rows(
            theirs, SHARED + ("DLK000",)))]


# -- the retargeted rules: each of the reference's JAX fixtures of DLK001-004,
# DLK009 and DLK010 beside a torch translation, line for line. Both must give
# the same active codes on the same lines (the reference's rules on the JAX
# source, the port's on the torch source).

PAIRS = {
    "bare-jit/call-and-decorators": ("""
        import jax, functools
        step = jax.jit(lambda x: x)

        @jax.jit
        def f(x):
            return x

        @functools.partial(jax.jit, static_argnums=(1,))
        def g(x, n):
            return x
    """, """
        import torch, functools
        step = torch.compile(lambda x: x)

        @torch.compile
        def f(x):
            return x

        @torch.jit.script
        def g(x, n):
            return x
    """),
    "bare-jit/from-import": ("""
        from jax import jit
        f = jit(lambda x: x)
    """, """
        from torch.cuda import make_graphed_callables
        f = make_graphed_callables(lambda x: x, (x,))
    """),
    "bare-jit/counting-clean": ("""
        from repro.core.tracing import counting_jit
        def step(x):
            return x
        f = counting_jit(step, "step")
    """, """
        from repro_torch.core.tracing import counting_call
        def step(x):
            return x
        f = counting_call(step, "step")
    """),
    "bare-jit/suppressed": ("""
        import jax
        f = jax.jit(lambda x: x)  # dalek: allow[bare-jit] fixture
    """, """
        import torch
        f = torch.compile(lambda x: x)  # dalek: allow[DLK001] fixture
    """),
    "host-sync/on-host-value-clean": ("""
        import jax
        import numpy as np
        step = jax.jit(lambda x: x)  # dalek: allow[bare-jit] fixture

        def drive(reqs):
            for r in reqs:
                p = np.asarray(r)
                y = step(p)
            return y
    """, """
        import torch
        import numpy as np
        step = counting_call(lambda x: x, "step")

        def drive(reqs):
            for r in reqs:
                p = torch.as_tensor(np.asarray(r))
                y = step(p)
            return y
    """),
    "host-sync/outside-loop-clean": ("""
        import jax
        import numpy as np
        step = jax.jit(lambda x: x)  # dalek: allow[bare-jit] fixture

        def drive(x):
            y = step(x)
            return np.asarray(y)
    """, """
        import torch
        import numpy as np
        step = counting_call(lambda x: x, "step")

        def drive(x):
            y = step(x)
            return y.cpu().numpy()
    """),
    "traced-branch/flagged": ("""
        import jax

        @jax.jit  # dalek: allow[bare-jit] fixture
        def f(x):
            if x > 0:
                return x
            return -x
    """, """
        import torch

        # a counted step: bound below
        def f(x):
            if x > 0:
                return x
            return -x
        f = counting_call(f, "f")
    """),
    "traced-branch/factory-and-name-arg": ("""
        import jax
        from repro.core.tracing import counting_jit

        def make_step(scale):
            def step(x):
                while x < scale:
                    x = x * 2
                return x
            return step

        def body(x):
            assert x > 0
            return x
        g = counting_jit(body, "body")
    """, """
        import torch
        from repro_torch.core.tracing import counting_call

        def make_step(scale):
            def step(x):
                while x < scale:
                    x = x * 2
                return x
            return step

        def body(x):
            assert x > 0
            return x
        g = counting_call(body, "body")
    """),
    "traced-branch/static-and-safe-clean": ("""
        import jax, functools

        @functools.partial(jax.jit, static_argnames=("n",))  # dalek: allow[bare-jit] fixture
        def f(x, n, key=None):
            if n > 2:                      # static: fine
                x = x + 1
            if key is None:                # identity test: fine
                x = x + 2
            if x.ndim == 2:                # shape introspection: fine
                x = x + 3
            return x
    """, """
        import torch, functools


        def f(x, n: int, key=None):
            if n > 2:                      # a host int: fine
                x = x + 1
            if key is None:                # identity test: fine
                x = x + 2
            if x.ndim == 2:                # shape introspection: fine
                x = x + 3
            return x
        f = counting_call(f, "f")
    """),
    "traced-branch/pragma-in-body": ("""
        import jax

        @jax.jit  # dalek: allow[bare-jit] fixture
        def f(x):
            y = x.sum()
            if y > 0:
                z = 1  # dalek: allow[traced-branch] must not reach the if
            return y
    """, """
        import torch


        def f(x):
            y = x.sum()
            if y > 0:
                z = 1  # dalek: allow[device-branch] must not reach the if
            return y
        f = counting_call(f, "f")
    """),
    "traced-branch/pragma-on-header": ("""
        import jax

        @jax.jit  # dalek: allow[bare-jit] fixture
        def f(x):
            y = x.sum()
            if y > 0:  # dalek: allow[traced-branch] fixture
                z = 1
            return y
    """, """
        import torch


        def f(x):
            y = x.sum()
            if y > 0:  # dalek: allow[device-branch] fixture
                z = 1
            return y
        f = counting_call(f, "f")
    """),
    "jit-kwargs/overlap-and-range": ("""
        import jax
        def f(a, b):
            return a + b
        g = jax.jit(f, static_argnums=(1,), donate_argnums=(1,))  # dalek: allow[bare-jit] fixture
        h = jax.jit(f, donate_argnums=(5,))  # dalek: allow[bare-jit] fixture
    """, """
        import torch
        def f(a, b):
            return a + b
        g = counting_call(f, "g", static_argnums=(1,), donate_argnums=(1,))
        h = counting_call(f, "h", donate_argnums=(5,))
    """),
    "jit-kwargs/unknown-argname": ("""
        import jax
        def f(x, n):
            return x * n
        g = jax.jit(f, static_argnames=("m",))  # dalek: allow[bare-jit] fixture
    """, """
        import torch
        def f(x, n):
            return x * n
        g = counting_call(f, "g", static_argnames=("m",))
    """),
    "jit-kwargs/clean": ("""
        import jax
        def f(state, batch, n):
            return state
        step = jax.jit(f, static_argnums=(2,), donate_argnums=(0,))  # dalek: allow[bare-jit] fixture

        def drive(state, batch):
            state = step(state, batch, 4)
            return state
    """, """
        import torch
        def f(state, batch, n):
            return state
        step = counting_call(f, "step")

        def drive(state, batch):
            state = step(state, batch, 4)
            return state
    """),
    "interproc/same-module": ("""
        import jax
        import numpy as np

        step = jax.jit(lambda x: x)  # dalek: allow[bare-jit] fixture

        def fetch(val):
            return np.asarray(val)

        def drive(xs):
            out = []
            for x in xs:
                y = step(x)
                out.append(fetch(y))
            return out
    """, """
        import torch
        import numpy as np

        step = counting_call(lambda x: x, "step")

        def fetch(val):
            return val.cpu().numpy()

        def drive(xs):
            out = []
            for x in xs:
                y = step(x)
                out.append(fetch(y))
            return out
    """),
    "interproc/clean-helper-keeps": ("""
        import jax

        step = jax.jit(lambda x: x)  # dalek: allow[bare-jit] fixture

        def keep(val):
            return val

        def drive(xs):
            for x in xs:
                y = step(x)
                z = keep(y)
    """, """
        import torch

        step = counting_call(lambda x: x, "step")

        def keep(val):
            return val

        def drive(xs):
            for x in xs:
                y = step(x)
                z = keep(y)
    """),
    "interproc/clean-host-argument": ("""
        import numpy as np

        def fetch(val):
            return np.asarray(val)

        def drive(xs):
            for x in xs:
                z = fetch(x)
    """, """
        import torch

        def fetch(val):
            return val.item()

        def drive(xs):
            for x in xs:
                z = fetch(x)
    """),
    "dtype-drift/pre-pin-conv": ("""
        import jax.numpy as jnp

        def causal_conv(x, w, state=None):
            width = w.shape[0]
            if state is None:
                xp = jnp.pad(x, ((0, 0), (width - 1, 0), (0, 0)))
            else:
                xp = jnp.concatenate([state.astype(x.dtype), x], axis=1)
            out = xp * w
            new_state = xp[:, -(width - 1):]
            return out, new_state
    """, """
        import torch

        def causal_conv(x, w, state=None):
            width = w.shape[0]
            if state is None:
                xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
            else:
                xp = torch.cat([state.to(x.dtype), x], dim=1)
            out = xp * w
            new_state = xp[:, -(width - 1):]
            return out, new_state
    """),
    "dtype-drift/pinned-clean": ("""
        import jax.numpy as jnp

        def causal_conv(x, w, state=None):
            width = w.shape[0]
            if state is None:
                xp = jnp.pad(x, ((0, 0), (width - 1, 0), (0, 0)))
            else:
                xp = jnp.concatenate([state.astype(x.dtype), x], axis=1)
            out = xp * w
            new_state = xp[:, -(width - 1):]
            if state is not None:
                new_state = new_state.astype(state.dtype)
            return out, new_state
    """, """
        import torch

        def causal_conv(x, w, state=None):
            width = w.shape[0]
            if state is None:
                xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
            else:
                xp = torch.cat([state.to(x.dtype), x], dim=1)
            out = xp * w
            new_state = xp[:, -(width - 1):]
            if state is not None:
                new_state = new_state.to(state.dtype)
            return out, new_state
    """),
    "dtype-drift/literal-cast-clean": ("""
        import jax.numpy as jnp

        def scan_step(carry, x):
            new = carry * 0.5 + x
            return new.astype(jnp.float32), x
    """, """
        import torch

        def scan_step(carry, x):
            new = carry * 0.5 + x
            return new.to(torch.float32), x
    """),
    "dtype-drift/no-carry-clean": ("""
        def project(x, w):
            return (x @ w).astype(x.dtype)
    """, """
        def project(x, w):
            return (x @ w).to(x.dtype)
    """),
}


def _hot_loop_jax(sync):
    return """
        import jax
        import numpy as np
        step = jax.jit(lambda x: x)  # dalek: allow[bare-jit] fixture

        def drive(x):
            for _ in range(8):
                x = step(x)
                {sync}
            return x
    """.replace("{sync}", sync)


def _hot_loop_torch(sync):
    return """
        import torch
        import numpy as np
        step = counting_call(lambda x: x, "step")

        def drive(x):
            for _ in range(8):
                x = step(x)
                {sync}
            return x
    """.replace("{sync}", sync)


# the reference's HOT_LOOP syncs beside their torch forms
for _jax, _torch in (("h = np.asarray(x)", "h = x.cpu().numpy()"),
                     ("h = x.item()", "h = x.item()"),
                     ("h = int(x)", "h = int(x)"),
                     ("h = float(np.asarray(x)[0])", "h = float(x.cpu()[0])"),
                     ("x.block_until_ready()", "torch.cuda.synchronize()"),
                     ("h = np.asarray(x)  # dalek: allow[host-sync] designed "
                      "fetch", "h = x.numpy()  # dalek: allow[host-sync] "
                      "designed fetch")):
    PAIRS[f"host-sync/{_jax}"] = (_hot_loop_jax(_jax), _hot_loop_torch(_torch))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_retargeted_rule_parity_with_reference(name):
    jax_src, torch_src = PAIRS[name]
    assert lines(lint(torch_src)) == lines(jlint(jax_src))


def test_retargeted_parity_pairs_cover_every_rule():
    hit = {code for jax_src, _ in PAIRS.values()
           for code, _ in lines(jlint(jax_src))}
    assert hit == set(RETARGETED)
    assert lines(jlint(PAIRS["interproc/same-module"][0])) \
        == [("DLK009", 14)]


def _interproc_project(tmp_path, helper, engine):
    (tmp_path / "helpers.py").write_text(textwrap.dedent(helper))
    (tmp_path / "engine.py").write_text(textwrap.dedent(engine))
    return [(Path(f.path).name, f.code, f.line) for f in
            analyze_project([str(tmp_path)]) if f.active]


def test_retargeted_interproc_cross_module_parity(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jax_side = _interproc_project(tmp_path / "j", """
        import numpy as np

        def fetch(val):
            return np.asarray(val)
    """, """
        import jax
        from helpers import fetch

        step = jax.jit(lambda x: x)  # dalek: allow[bare-jit] fixture

        def drive(xs):
            out = []
            for x in xs:
                y = step(x)
                out.append(fetch(y))
            return out
    """)
    torch_side = _interproc_project(tmp_path / "t", """
        import torch

        def fetch(val):
            return val.tolist()
    """, """
        import torch
        from helpers import fetch

        step = counting_call(lambda x: x, "step")

        def drive(xs):
            out = []
            for x in xs:
                y = step(x)
                out.append(fetch(y))
            return out
    """)
    # the port's linter on the JAX side sees no counted step; on the torch
    # side it finds what the reference finds on the JAX side
    jax_ref = [(Path(f.path).name, f.code, f.line) for f in
               janalysis.analyze_project([str(tmp_path / "j")]) if f.active]
    assert jax_side == []
    assert torch_side == jax_ref == [("engine.py", "DLK009", 11)]


def test_interproc_sync_transitive_and_suppressed(tmp_path):
    (tmp_path / "deep.py").write_text(textwrap.dedent("""
        import torch

        step = counting_call(lambda x: x, "step")

        def as_host(v):
            return v.to("cpu")

        def fetch(val):
            return as_host(val)

        def drive(xs):
            for x in xs:
                y = step(x)
                z = fetch(y)  # dalek: allow[interproc-host-sync] fixture
        """))
    fs = analyze_project([str(tmp_path)])
    assert active(fs, "DLK009") == []
    assert any(f.code == "DLK009" and f.suppressed for f in fs)
    src = (tmp_path / "deep.py").read_text().replace(
        "  # dalek: allow[interproc-host-sync] fixture", "")
    (tmp_path / "deep.py").write_text(src)
    act = active(analyze_project([str(tmp_path)]), "DLK009")
    assert len(act) == 1 and "fetch" in act[0].message


def test_interproc_project_index_resolves_torch_syncs(tmp_path):
    (tmp_path / "util.py").write_text(textwrap.dedent("""
        def pull(v):
            return v.cpu().numpy()

        class Sink:
            def drain(self, v):
                return v.item()
    """))
    (tmp_path / "main.py").write_text(textwrap.dedent("""
        from util import pull, Sink
        import util

        def a(v):
            return pull(v)

        def b(v):
            return util.pull(v)
    """))
    index, errors = ProjectIndex.from_paths([str(tmp_path)])
    assert errors == []
    by_suffix = {fq.rsplit(".", 1)[-1]: s
                 for fq, s in index.summaries.items()}
    assert 0 in by_suffix["pull"].syncs_params
    assert 0 in by_suffix["a"].syncs_params
    assert 0 in by_suffix["b"].syncs_params
    assert 1 in by_suffix["drain"].syncs_params


def test_project_returns_device_through_counted_calls(tmp_path):
    (tmp_path / "m.py").write_text(textwrap.dedent("""
        class Adapter:
            def __init__(self, fn):
                self._decode = counting_call(fn, "decode")

            def decode_step(self, x):
                return self._decode(x)

            def host_step(self, x):
                return int(self._decode(x))
    """))
    index, _ = ProjectIndex.from_paths([str(tmp_path)])
    s = {fq.rsplit(".", 1)[-1]: v for fq, v in index.summaries.items()}
    assert s["decode_step"].returns_device
    assert not s["host_step"].returns_device


# -- DLK010 on the port's own code ------------------------------------------------

XLSTM = REPO / "src" / "repro_torch" / "models" / "xlstm.py"
PIN = """    if state is not None:
        new_state = new_state.to(state.dtype)
"""


def test_dtype_drift_flags_xlstm_causal_conv_without_its_pin():
    src = XLSTM.read_text()
    assert src.count(PIN) == 1
    assert active(analyze_source(src, "models/xlstm.py"), "DLK010") == []
    cut = src.replace(PIN, "")
    act = active(analyze_source(cut, "models/xlstm.py"), "DLK010")
    assert len(act) == 1 and "_causal_conv" in act[0].message
    assert act[0].line_text.strip() == "return out, new_state"


@pytest.mark.parametrize("cast,want", [
    ("state.to(x.dtype)", ["DLK010"]), ("state.to(dtype=x.dtype)", ["DLK010"]),
    ("state.type_as(x)", ["DLK010"]), ("state.to(x)", ["DLK010"]),
    ("state.to(x.device, x.dtype)", ["DLK010"]),
    ("state.float()", []), ("state.to(torch.float32)", []),
    ("state.bfloat16()", []), ("state.to(x.device)", []),
    ("state.to('cuda')", []),
])
def test_dtype_drift_cast_forms(cast, want):
    fs = lint(f"""
        import torch

        def step(x, state):
            xp = torch.cat([{cast}, x], dim=1).contiguous()
            new_state = xp[:, 1:]
            return x, new_state
    """)
    assert codes(fs) == want


@pytest.mark.parametrize("pin", [
    "xp.to(state.dtype)", "xp.type_as(state)", "xp.to(dtype=state.dtype)",
    "xp.to(state)",
])
def test_dtype_drift_pins_clean(pin):
    src = """
        import torch

        def step(x, state):
            xp = torch.stack([state.to(x.dtype), x]).flip(0)
            new_state = {pin}
            return x, new_state
    """
    assert codes(lint(src.format(pin="xp"))) == ["DLK010"]
    assert codes(lint(src.format(pin=pin))) == []


def test_dtype_drift_suppressed():
    src = PAIRS["dtype-drift/pre-pin-conv"][1].replace(
        "return out, new_state",
        "return out, new_state  # dalek: allow[dtype-drift] fixture")
    fs = lint(src)
    assert active(fs, "DLK010") == []
    assert any(f.code == "DLK010" and f.suppressed for f in fs)


# -- suppression, baseline, CLI ---------------------------------------------------


def test_pragma_allow_all_code_token_and_wrapped_statement():
    fs = lint("""
        import torch
        f = torch.compile(lambda x: x)  # dalek: allow[all]
        g = torch.compile(lambda x: x)  # dalek: allow[DLK001]
        h = torch.compile(
            lambda x: x)  # dalek: allow[bare-compile] wrapped fixture
    """)
    assert active(fs) == [] and sum(f.suppressed for f in fs) == 3


def test_list_rules_lists_dlk001_to_dlk012(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out] == [f"DLK{i:03d}"
                                             for i in range(1, 13)]
    assert rule_codes() == janalysis.rule_codes()
    slugs = {ln.split()[0]: ln.split()[1] for ln in out}
    assert (slugs["DLK001"], slugs["DLK003"], slugs["DLK004"]) \
        == ("bare-compile", "device-branch", "step-kwargs")


def test_baseline_round_trip_and_determinism(tmp_path):
    src = "import torch\nf = torch.compile(lambda x: x)\n"
    fs = lint(src)
    bl = tmp_path / "baseline.json"
    baseline_mod.save(fs, bl)
    first = bl.read_bytes()
    baseline_mod.save(fs, bl)
    assert bl.read_bytes() == first
    doc = json.loads(first)
    assert doc["counts"] == {"DLK001": 1}
    assert "repro_torch.analysis" in doc["comment"]
    fs2 = lint(src)
    baseline_mod.apply(fs2, baseline_mod.load(bl))
    assert all(f.baselined for f in fs2) and active(fs2) == []


def test_cli_exit_codes_gate_json_and_baseline(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nf = torch.compile(lambda x: x)\n")
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert cli_main([str(bad)]) == 1
    assert cli_main([str(good)]) == 0
    assert cli_main(["--select", "DLK002", str(bad)]) == 0
    assert cli_main(["--ignore", "bare-compile", str(bad)]) == 0
    bl = tmp_path / "bl.json"
    assert cli_main([str(bad), "--baseline-file", str(bl),
                     "--write-baseline"]) == 0
    assert cli_main([str(bad), "--baseline-file", str(bl), "--baseline"]) == 0
    gate = tmp_path / "gate.json"
    assert cli_main([str(bad), "--gate-json", str(gate)]) == 1
    got = json.loads(gate.read_text())
    assert got["analysis/total"] == {"findings": 1}
    assert got["analysis/DLK001"] == {"findings": 1}
    assert set(got) == {f"analysis/{c}" for c in rule_codes()} \
        | {"analysis/total"}


def test_gate_rows_shape_is_the_reference_s():
    assert gate_rows([]) == jgate_rows([])
    assert all(v == {"findings": 0} for v in gate_rows([]).values())


def test_gate_rows_read_by_the_port_s_regression_gate(tmp_path, capsys):
    cur = tmp_path / "cur.json"
    assert cli_main(["--project", str(tmp_path), "--gate-json",
                     str(cur)]) == 0
    raised = json.loads(cur.read_text())
    raised["analysis/DLK003"]["findings"] += 1
    (tmp_path / "raised.json").write_text(json.dumps(raised))
    assert regression_gate.main([str(cur), str(cur)]) == 0
    assert regression_gate.main([str(cur), str(tmp_path / "raised.json")]) \
        == 1
    assert "static-analysis findings regressed 0 -> 1" \
        in capsys.readouterr().out


def test_project_output_deterministic_under_shuffle(tmp_path, capsys):
    (tmp_path / "one.py").write_text(
        "import torch\nf = torch.compile(lambda x: x)\n")
    (tmp_path / "two.py").write_text(
        "def fetch(v):\n    return v.cpu().numpy()\n")
    (tmp_path / "three.py").write_text("x = 1\n")
    names = ["one.py", "two.py", "three.py"]
    outs, gates = [], []
    for order in (names, list(reversed(names)), names[1:] + names[:1]):
        gate = tmp_path / "gate.json"
        argv = ["--project"] + [str(tmp_path / n) for n in order] \
            + ["--json", "--gate-json", str(gate)]
        cli_main(argv)
        outs.append(capsys.readouterr().out.encode())
        gates.append(gate.read_bytes())
    assert outs[0] == outs[1] == outs[2]
    assert gates[0] == gates[1] == gates[2]


# -- the port is clean under its own linter -------------------------------------


def test_default_paths_are_the_port():
    paths = [Path(p).relative_to(REPO).as_posix()
             for p in default_paths(str(REPO))]
    assert paths[:2] == ["src/repro_torch", "chip_smoke.py"]
    assert "tests/test_torch_analysis.py" in paths
    assert paths[-1] == "tests/torch_dist_worker.py"
    assert all(re.match(r"tests/test_torch_\w+\.py$", p)
               for p in paths[2:-1])


@pytest.fixture(scope="module")
def project_run():
    """``python -m repro_torch.analysis --project --baseline --json`` from
    the repo root, over the default paths: (exit code, the JSON)."""
    cwd = os.getcwd()
    out = io.StringIO()
    try:
        os.chdir(REPO)
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["--project", "--baseline", "--json"])
    finally:
        os.chdir(cwd)
    return rc, json.loads(out.getvalue())


def test_port_is_lint_clean_modulo_baseline():
    findings = analyze_paths(default_paths(str(REPO)))
    baseline_mod.apply(findings, baseline_mod.load())
    assert [f.render() for f in findings if f.active] == []


def test_port_is_project_clean_modulo_baseline(project_run):
    rc, doc = project_run
    assert rc == 0 and doc["summary"]["active"] == 0
    assert doc["summary"]["baselined"] == 0
    # the quickstart's per-third-step loss print carries the reference's
    # pragma, as the engine's designed fetch does
    suppressed = {(f["path"], f["code"]) for f in doc["findings"]
                  if f["suppressed"]}
    assert ("src/repro_torch/examples/quickstart.py", "DLK002") in suppressed
    assert ("src/repro_torch/serve/engine.py", "DLK002") in suppressed


@pytest.mark.parametrize("code", ["DLK001", "DLK008", "DLK009", "DLK010"])
def test_checked_in_baseline_has_no_fix_only_findings(code):
    keys = baseline_mod.load()
    assert not any(c == code for c, _, _ in keys)


def test_checked_in_baseline_is_empty():
    doc = json.loads(baseline_mod.DEFAULT_BASELINE.read_text())
    assert doc["findings"] == [] and doc["counts"] == {}


def test_analysis_package_imports_the_standard_library_only():
    pkg = REPO / "src" / "repro_torch" / "analysis"
    stdlib = {"__future__", "argparse", "ast", "dataclasses", "glob",
              "hashlib", "json", "pathlib", "re", "sys", "typing", "os"}
    for path in sorted(pkg.glob("*.py")):
        for m in re.finditer(r"^\s*(?:from|import)\s+([\w.]+)",
                             path.read_text(), re.M):
            top = m.group(1).split(".")[0]
            assert top in stdlib or m.group(1).startswith(
                "repro_torch.analysis"), (path.name, m.group(1))
    assert os.path.exists(pkg / "baseline.json")

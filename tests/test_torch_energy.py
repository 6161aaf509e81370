"""The hardware registry and the energy model in both packages: the hw and
energy cases of ``tests/test_energy.py`` (DVFS, power cap, Pareto sweep,
the paper's Tab. 2 totals) on the reference and on the port (``pkg``; the
DVFS cases on each package's serving device, the reference's TPU v5e and
the port's H100 SXM), then the port's energy functions held to the
reference's on the same ``DeviceSpec`` values."""
import dataclasses
import importlib
import types

import numpy as np
import pytest

from repro.core import energy as jenergy
from repro.core import hw as jhw
from repro_torch.core import energy as tenergy
from repro_torch.core import hw as thw

SERVING_DEVICE = {"repro": "TPU_V5E", "repro_torch": "H100_SXM"}


@pytest.fixture(params=sorted(SERVING_DEVICE), scope="module")
def pkg(request):
    hw = importlib.import_module(f"{request.param}.core.hw")
    return types.SimpleNamespace(
        hw=hw, energy=importlib.import_module(f"{request.param}.core.energy"),
        dev=getattr(hw, SERVING_DEVICE[request.param]))


def test_dvfs_cubic_power_monotone(pkg):
    dev, energy = pkg.dev, pkg.energy
    powers = [energy.power_w(dev, 1.0, energy.DvfsState(f))
              for f in np.linspace(dev.f_min_ghz, dev.f_max_ghz, 5)]
    assert all(a < b for a, b in zip(powers, powers[1:]))
    assert abs(powers[-1] - dev.tdp_w) < 1e-6


def test_power_cap_respected(pkg):
    dev, energy = pkg.dev, pkg.energy
    terms = {"compute": 1.0, "memory": 0.4, "collective": 0.2}
    cap = 150.0
    st = energy.cap_frequency(cap, terms, dev)
    t = energy.step_time_s(terms, st, dev)
    avg_w = energy.step_energy_j(terms, st, dev) / t
    assert avg_w <= cap + 1e-6
    # capping costs time
    assert t >= energy.step_time_s(terms, None, dev)


def test_pareto_energy_time_tradeoff(pkg):
    terms = {"compute": 1.0, "memory": 0.3, "collective": 0.1}
    front = pkg.energy.pareto_frontier(terms)
    times = [p["step_s"] for p in front]
    assert times[0] > times[-1]          # higher f -> faster


def test_cluster_idle_power_paper_claim(pkg):
    # Sec. 3.4: idle cluster (nodes off) ~50 W
    assert 40.0 <= pkg.hw.cluster_idle_w("off") <= 60.0
    # Tab. 2 totals
    idle = pkg.hw.cluster_idle_w("idle")
    assert abs(idle - pkg.hw.PAPER_TOTALS["idle_w"]) < 1.0


def test_paper_suspend_total(pkg):
    susp = sum(p.suspend_w for p in pkg.hw.DALEK_PARTITIONS.values())
    assert abs(susp - pkg.hw.PAPER_TOTALS["suspend_w"]) < 1.0


def test_paper_tdp_total(pkg):
    hw = pkg.hw
    tdp = (sum(p.tdp_w for p in hw.DALEK_PARTITIONS.values())
           + hw.FRONTEND.tdp_w + hw.SWITCH_TDP_W + hw.N_RPI * hw.RPI_TDP_W)
    assert abs(tdp - hw.PAPER_TOTALS["tdp_w"]) < 1.0


# ---------------------------------------------------------------------------
# the port's energy functions against the reference's, same DeviceSpec


TERMS = ({"compute": 1.0, "memory": 0.3, "collective": 0.1},
         {"compute": 2e-4, "memory": 1.7e-2, "collective": 0.0})


def _devs(name):
    """(reference spec, port spec) with the port's values for ``name``."""
    tdev = getattr(thw, name)
    return jhw.DeviceSpec(**dataclasses.asdict(tdev)), tdev


@pytest.mark.parametrize("name", ["H100_SXM", "RTX_4090", "RADEON_890M"])
@pytest.mark.parametrize("terms", TERMS, ids=["compute", "memory"])
def test_energy_functions_are_the_reference(name, terms):
    jdev, tdev = _devs(name)
    dvfs = (None, 0.5 * (tdev.f_min_ghz + tdev.f_max_ghz))
    for f in dvfs:
        js = jenergy.DvfsState(f) if f else None
        ts = tenergy.DvfsState(f) if f else None
        assert tenergy.tokens_per_joule(terms, 256, 1, ts, tdev) \
            == jenergy.tokens_per_joule(terms, 256, 1, js, jdev)
        t = np.linspace(0.0, 3.0 * jenergy.step_time_s(terms, js, jdev), 97)
        assert np.array_equal(tenergy.power_trace_fn(terms, ts, tdev)(t),
                              jenergy.power_trace_fn(terms, js, jdev)(t))
    assert tenergy.pareto_frontier(terms, tdev) \
        == jenergy.pareto_frontier(terms, jdev)
    for cap in (60.0, 150.0, 400.0):
        assert tenergy.cap_frequency(cap, terms, tdev).f_ghz \
            == jenergy.cap_frequency(cap, terms, jdev).f_ghz


def test_port_energy_defaults_to_the_h100():
    terms = TERMS[0]
    jdev, _ = _devs("H100_SXM")
    assert tenergy.pareto_frontier(terms) \
        == jenergy.pareto_frontier(terms, jdev)
    assert tenergy.tokens_per_joule(terms, 8, 1) \
        == jenergy.tokens_per_joule(terms, 8, 1, None, jdev)
    assert tenergy.power_trace_fn(terms)(0.0) \
        == jenergy.power_trace_fn(terms, None, jdev)(0.0)

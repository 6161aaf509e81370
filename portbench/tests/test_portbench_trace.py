"""Reduction of a profiler session's kernel timeline, and the flash
kernel's operation and byte counts."""
import pytest

from portbench import roofline, spec, trace

M = trace.MARKER


def _timeline(kernels, lead=3, tail=trace.TAIL):
    ev = [(i, i + 1, M) for i in range(lead)]
    ev += kernels
    end = max(e for _, e, _ in kernels) + 10
    ev += [(end + i, end + i + 1, M) for i in range(tail)]
    return ev


def test_idle_share_from_a_synthetic_timeline():
    # busy 100-200 and 150-250 overlap (150 ns busy together), idle
    # 250-400, busy 400-500: span 400, busy 250
    kernels = [(100, 200, "a"), (150, 250, "b"), (400, 500, "a")]
    s = trace.reduce_session(_timeline(kernels))
    assert s["span_s"] == pytest.approx(400e-9)
    assert s["busy_s"] == pytest.approx(250e-9)
    assert s["gaps"] == [(250, 400)]
    idle = spec.metric_reader("idle_share")({"sessions": [s]})
    assert idle == pytest.approx(100 * 150 / 400)
    assert trace.kernel_seconds([s]) == pytest.approx(
        {"a": 200e-9, "b": 100e-9})


def test_kernel_names_lose_their_argument_lists():
    assert trace.short_name(
        "void (anonymous namespace)::flash_fwd_wgmma_kernel<128>("
        "CUtensorMap_st, int)") == "flash_fwd_wgmma_kernel<128>"
    assert trace.short_name("nvjet_tst_192x192_64x3") == \
        "nvjet_tst_192x192_64x3"


def test_a_session_that_lost_records_is_left_out():
    kernels = [(100, 200, "a")]
    assert trace.reduce_session(_timeline(kernels, lead=0)) is None
    assert trace.reduce_session(_timeline(kernels, tail=trace.TAIL - 1)) \
        is None
    assert spec.metric_reader("idle_share")({"sessions": []}) is None


def test_a_session_whose_kernels_miss_its_host_time_is_left_out():
    kernels = [(100, 200, "a"), (400, 500, "a")]
    ev = _timeline(kernels)
    tail = ev[len(ev) - trace.TAIL][0]
    # kernels span 400 ns of a session that ran 440 ns on the host: kept;
    # of one that ran 1000 ns: records were lost between the markers
    assert trace.reduce_session(ev, tail, tail - 440) is not None
    assert trace.reduce_session(ev, tail, tail - 1000) is None


def test_idle_gaps_go_to_the_host_span_that_holds_them():
    kernels = [(100, 200, "a"), (400, 500, "a")]
    ev = _timeline(kernels)
    first_tail = ev[len(ev) - trace.TAIL][0]
    s = trace.reduce_session(ev, host_tail_ns=first_tail - 1000)
    # trace = host + 1000: the gap 200-400 (middle 300) is host time -700
    by = trace.idle_by_span([s], [("decode_step", -800, -600)])
    assert by == pytest.approx({"decode_step": 200e-9})


@pytest.mark.parametrize("s,t,off", [(8, 8, 0), (5, 64, 17), (64, 40, 0),
                                     (16, 32, 20), (7, 7, 3)])
def test_flash_cost_counts_each_visible_pair(s, t, off):
    pairs = sum(1 for i in range(s) for j in range(t) if j <= off + i)
    flops, nbytes = roofline.flash_cost(2, 4, 1, s, t, 8, off, True, None)
    assert flops == 4 * 2 * 4 * 8 * pairs
    keys = min(t, off + s)
    assert nbytes == 2 * 2 * 8 * (2 * 4 * s + 2 * 1 * keys)


def test_flash_roofline_is_least_time_over_kernel_time():
    rec = {"flash": {"least_s": 0.3, "kernel_s": 0.5, "launches": 52}}
    assert spec.metric_reader("flash_roofline")(rec) == pytest.approx(60.0)
    assert spec.metric_reader("flash_roofline")({"flash": None}) is None

"""The readers of the program's own spans and counters
(port_bench/program.py and six metrics/<name>.py): each on a synthetic
traced window with known spans, gaps and launches, on a program that
keeps no counters, and on the tiny CPU cells with --trace 1.  A reader
gives its value or None and never raises."""

import pytest

from port_bench import program, spec
from port_bench.readings import Readings
from port_bench.tests import tiny
from port_bench.trace import Interval, Trace

MS = 1_000_000  # ns
NEW = ("enqueue_ms.bake", "cull_launches.bake", "cull_keep_pct.bake",
       "stragglers_pct.bake", "sync_idle_ms.bake", "pack_program_s")
COUNTERS = {"cull.candidates": 30, "cull.pairs": 120,
            "twopass.rays.stragglers": 5, "twopass.rays.pass1": 200,
            "pack.bvh": 0.5, "pack.tbl": 0.25, "pack.texels": 0.25,
            "twopass.calls": 2}


def _iv(a, b, name):
    return Interval(a * MS, b * MS, name)


def _window():
    """Two batches in 100 ms.  Batch 1 [0, 40]: a cull [2, 10] with three
    launches, a walk; the sync [20, 25], a re-trace [26, 40] with its own
    cull [30, 34] and two launches, the card idle [22, 30].  Batch 2 [50,
    80]: a cull [52, 58] with one launch, the sync [60, 66], a re-trace
    [67, 80], the card idle [64, 70].  One launch outside any cull, one
    cudaMemcpyAsync inside one (not a kernel launch)."""
    host = [
        _iv(0, 40, "texir.bake.batch"), _iv(50, 80, "texir.bake.batch"),
        _iv(2, 10, "texir.cull"), _iv(3, 3.01, "cudaLaunchKernel"),
        _iv(5, 5.01, "cudaLaunchKernelExC"), _iv(9, 9.01, "cuLaunchKernel"),
        _iv(6, 6.01, "cudaMemcpyAsync"), _iv(12, 12.01, "cudaLaunchKernel"),
        _iv(20, 25, "texir.twopass.sync"),
        _iv(26, 40, "texir.twopass.retrace"),
        _iv(30, 34, "texir.cull"), _iv(31, 31.01, "cudaLaunchKernel"),
        _iv(33, 33.01, "cudaLaunchKernel"),
        _iv(52, 58, "texir.cull"), _iv(53, 53.01, "cudaLaunchKernel"),
        _iv(60, 66, "texir.twopass.sync"),
        _iv(67, 80, "texir.twopass.retrace"), _iv(70, 80, "aten::add"),
    ]
    kernels = [(_iv(3, 22, "culled_walk_kernel"), None),
               (_iv(30, 64, "elementwise_kernel"), None),
               (_iv(70, 90, "culled_walk_kernel"), None)]
    return Trace(window=(0, 100 * MS), kernels=kernels, copies=[],
                 host=host, spans=[])


def _read(name, trace=None, kind="bake", units=2):
    r = Readings(kind=kind, units=units, trace=trace, host={})
    return spec.reader(name).read(r)


@pytest.fixture
def with_counters(monkeypatch):
    monkeypatch.setattr(program, "counters", lambda: dict(COUNTERS))


def test_readers_on_a_known_window(with_counters):
    tr = _window()
    # the batches less their syncs: 40 - 5 and 30 - 6
    assert _read("enqueue_ms.bake", tr) == pytest.approx(29.5)
    # 3 launches in the first cull, 2 in pass 2's, 1 in the second batch's
    assert _read("cull_launches.bake", tr) == pytest.approx(3.0)
    assert _read("cull_keep_pct.bake", tr) == pytest.approx(25.0)
    assert _read("stragglers_pct.bake", tr) == pytest.approx(2.5)
    # idle from each sync's end to its re-trace's: [25, 30] and [66, 70]
    assert _read("sync_idle_ms.bake", tr) == pytest.approx(4.5)
    assert _read("pack_program_s", tr) == pytest.approx(1.0)


def test_a_sync_that_ends_while_the_card_runs_adds_nothing():
    tr = _window()
    tr.kernels.append((_iv(19, 32, "memcpy_like_kernel"), None))
    # the card now runs through the first re-trace; the second's gap stays
    assert _read("sync_idle_ms.bake", tr) == pytest.approx(2.0)
    assert program.idle_ns(tr, [(25 * MS, 40 * MS)]) == 0
    assert program.idle_ns(tr, [(66 * MS, 80 * MS)]) == 4 * MS


def _ladder(host):
    kernels = [(_iv(0, 11, "culled_walk_kernel"), None),
               (_iv(30, 35, "elementwise_kernel"), None)]
    return Trace(window=(0, 60 * MS), kernels=kernels, copies=[],
                 host=[_iv(0, 55, "texir.bake.batch")] + host, spans=[])


def test_sync_idle_pairs_each_sync_with_its_retrace():
    """The three-pass ladder: pass 2's own sync and re-trace lie inside
    the outer re-trace, and their stretch counts once.  A sync whose
    re-trace follows another sync, or falls outside the window, adds
    nothing."""
    ladder = _ladder([_iv(10, 12, "texir.twopass.sync"),
                      _iv(13, 50, "texir.twopass.retrace"),
                      _iv(20, 22, "texir.twopass.sync"),
                      _iv(23, 40, "texir.twopass.retrace")])
    # [12, 50] less the card's [30, 35]
    assert _read("sync_idle_ms.bake", ladder, units=1) == pytest.approx(33.0)
    # less the two syncs: 55 - 2 - 2
    assert _read("enqueue_ms.bake", ladder, units=1) == pytest.approx(51.0)
    two = _ladder([_iv(10, 12, "texir.twopass.sync"),
                   _iv(20, 22, "texir.twopass.sync"),
                   _iv(23, 30, "texir.twopass.retrace")])
    assert _read("sync_idle_ms.bake", two, units=1) == pytest.approx(8.0)
    cut = _ladder([_iv(50, 52, "texir.twopass.sync"),
                   _iv(53, 70, "texir.twopass.retrace")])
    assert _read("sync_idle_ms.bake", cut, units=1) is None


def test_helpers():
    ivs = [_iv(5, 7, "a"), _iv(0, 2, "a"), _iv(1, 3, "a")]
    assert program.merged(ivs) == [(0, 3 * MS), (5 * MS, 7 * MS)]
    times = sorted(x * MS for x in (0.5, 2.5, 4, 6, 8))
    assert program.count_inside(times, program.merged(ivs)) == 3


@pytest.mark.parametrize("name", NEW)
def test_none_where_there_is_nothing_to_read(name, monkeypatch):
    """No trace, a Mat run's, a window without the program's spans, a
    device that ran nothing, and a program that keeps no counters (the
    parent of the change that added them)."""
    from texir_code_tpu_torch import profiling

    monkeypatch.delattr(profiling, "counters")
    assert program.counters() is None
    bare = Trace(window=(0, 10 * MS), kernels=[], copies=[],
                 host=[_iv(1, 2, "aten::add")], spans=[])
    assert _read(name, None) is None
    assert _read(name, _window(), kind="mat") is None
    assert _read(name, bare) is None


def test_stragglers_none_without_a_two_pass(monkeypatch):
    monkeypatch.setattr(program, "counters",
                        lambda: {"cull.pairs": 10, "cull.candidates": 5})
    assert _read("stragglers_pct.bake", _window()) is None
    assert _read("pack_program_s", _window()) is None
    assert _read("cull_keep_pct.bake", _window()) == pytest.approx(50.0)


def test_cpu_cells_with_trace(tmp_path):
    """On the tiny cells the readers of the program's spans and counters
    read; those of the device's gaps and launches give None (a CPU run
    has neither)."""
    from texir_code_tpu_torch import profiling

    root, bench = tiny.make_root(tmp_path)
    for cell, expect in (("apartment-bake", {"enqueue_ms.bake",
                                             "cull_keep_pct.bake",
                                             "pack_program_s"}),
                         ("building-bake", {"enqueue_ms.bake",
                                            "cull_keep_pct.bake",
                                            "stragglers_pct.bake",
                                            "pack_program_s"})):
        profiling.reset_counters()
        out = tiny.run(root, bench, cell, trace=True)
        got = {k: v["value"] for k, v in out["metrics"].items()}
        assert {k for k in got if k in NEW} == expect, cell
        assert 0 < got["cull_keep_pct.bake"] <= 100
        assert 0 < got["pack_program_s"] <= got["pack_s"]
        assert got["enqueue_ms.bake"] > 0
        if "stragglers_pct.bake" in got:
            assert 0 < got["stragglers_pct.bake"] <= 100
        assert out["correct"]

"""The port's spans (`utils.profiling`): `PhaseTimer`'s nested spans and
their aggregates, the `enable_spans` switch, the spans `solve` records
(``result.aux["spans"]``) and the profiler ranges they open, and the merge
of the re-solves' spans under ``quad_adapt``.  The capture's spans run on
the card only (`tests/test_torch_cuda.py`)."""

import importlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import neuralpde_tpu_torch as tpkg
from neuralpde_tpu_torch import train
from neuralpde_tpu_torch.utils import profiling

from _torch_parity import mlp_params, poisson_2d

F64 = torch.float64
SOLVE_SPANS = ("solve", "solve.build", "solve.eager_step", "solve.read",
               "solve.block_end", "solve.callback", "solve.finish")


@pytest.fixture(autouse=True)
def spans_switch():
    """Each test finds the switch as the process had it and leaves it so."""
    before = profiling.spans_enabled()
    yield
    profiling.enable_spans(before)


def _prob():
    tree = mlp_params(np.random.default_rng(0), [2, 8, 8, 1])
    return tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([2, 8, 8, 1], dtype=F64), tpkg.GridTraining(0.5),
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=F64,
        device="cpu"))


def _solve_with_spans(**kw):
    profiling.enable_spans(True)
    seen = []
    res = tpkg.solve(_prob(), maxiters=4, inner_steps=2,
                     callback=lambda it, loss, aux: seen.append(it) and False,
                     **kw)
    assert seen == [2, 4]
    return res


class Clock:
    """A stand-in for `time.perf_counter` that reads the times it is set
    to."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_spans_are_off_by_default_and_record_nothing(monkeypatch):
    assert not profiling.spans_enabled()

    def no_timer():
        raise AssertionError("a PhaseTimer was made with spans off")

    monkeypatch.setattr(train, "PhaseTimer", no_timer)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = tpkg.solve(_prob(), maxiters=4, inner_steps=2,
                         callback=lambda it, loss, aux: False)
    assert "spans" not in res.aux
    assert not [e.name for e in prof.events()
                if e.name.startswith("solve")]


def test_enable_spans_switches_the_process():
    profiling.enable_spans()
    assert profiling.spans_enabled()
    profiling.enable_spans(False)
    assert not profiling.spans_enabled()


def test_solve_counts_its_spans():
    spans = _solve_with_spans().aux["spans"]
    counts = {name: s["count"] for name, s in spans.items()}
    assert counts == {"solve": 1, "solve.build": 1, "solve.eager_step": 4,
                      "solve.read": 2, "solve.block_end": 2,
                      "solve.callback": 2, "solve.finish": 1}
    assert spans["solve"]["parent"] is None
    assert {s["parent"] for name, s in spans.items()
            if name != "solve"} == {"solve"}


def test_child_spans_lie_within_their_parents():
    spans = _solve_with_spans().aux["spans"]
    children = 0.0
    for name, s in spans.items():
        assert 0.0 <= s["self_s"] <= s["total_s"]
        assert s["max_s"] <= s["total_s"]
        if s["parent"] is not None:
            assert s["total_s"] <= spans[s["parent"]]["total_s"]
            children += s["total_s"]
    solve = spans["solve"]
    assert children <= solve["total_s"]
    np.testing.assert_allclose(solve["self_s"], solve["total_s"] - children,
                               rtol=1e-9, atol=1e-12)


def test_solve_spans_are_profiler_ranges_inside_solve():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve_with_spans()
    events = [e for e in prof.events() if e.name in SOLVE_SPANS]
    assert {e.name for e in events} == set(SOLVE_SPANS)
    (outer,) = [e for e in events if e.name == "solve"]
    for e in events:
        assert outer.time_range.start <= e.time_range.start
        assert e.time_range.end <= outer.time_range.end
    assert sum(e.name == "solve.eager_step" for e in events) == 4


def test_profile_dir_turns_spans_on_for_its_run(tmp_path):
    res = tpkg.solve(_prob(), maxiters=4, inner_steps=2,
                     profile_dir=str(tmp_path))
    assert not profiling.spans_enabled()
    assert res.aux["spans"]["solve.eager_step"]["count"] == 4
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"solve.eager_step", "solve.read", "solve.block_end"} <= names


def test_phase_timer_aggregates_nested_spans(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    timer = profiling.PhaseTimer()
    for outer, inner in ((10.0, (2.0, 1.0)), (4.0, (3.0,))):
        start = clock.now
        timer.open("outer")
        for seconds in inner:
            timer.open("inner")
            timer.add("inner", "items", 2)
            clock.now += seconds
            assert timer.close() == seconds
        clock.now = start + outer
        timer.close()
    assert timer.summary() == {
        "outer": {"total_s": 14.0, "self_s": 8.0, "count": 2, "max_s": 10.0,
                  "parent": None},
        "inner": {"total_s": 6.0, "self_s": 6.0, "count": 3, "max_s": 3.0,
                  "parent": "outer", "items": 6}}


def test_phase_closes_its_span_when_the_block_raises(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    timer = profiling.PhaseTimer()
    with pytest.raises(ValueError):
        with timer.phase("outer"):
            with timer.phase("inner"):
                clock.now = 5.0
                raise ValueError
    summary = timer.summary()
    assert summary["inner"]["total_s"] == 5.0
    assert summary["outer"] == {"total_s": 5.0, "self_s": 0.0, "count": 1,
                                "max_s": 5.0, "parent": None}


def test_phase_timer_opens_ranges_only_while_a_profiler_records():
    timer = profiling.PhaseTimer()
    with timer.phase("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("during"):
            pass
    names = {e.name for e in prof.events()}
    assert "during" in names and "before" not in names
    assert set(timer.summary()) == {"before", "during"}


def test_merge_summaries_sums_and_keeps_the_largest_span():
    a = {"solve": {"total_s": 2.0, "self_s": 1.0, "count": 1, "max_s": 2.0,
                   "parent": None},
         "solve.capture": {"total_s": 0.5, "self_s": 0.5, "count": 1,
                           "max_s": 0.5, "parent": "solve", "segments": 3}}
    b = {"solve": {"total_s": 3.0, "self_s": 2.5, "count": 1, "max_s": 3.0,
                   "parent": None},
         "solve.capture": {"total_s": 0.25, "self_s": 0.25, "count": 1,
                           "max_s": 0.25, "parent": "solve", "segments": 1},
         "solve.replay": {"total_s": 0.1, "self_s": 0.1, "count": 9,
                          "max_s": 0.02, "parent": "solve"}}
    merged = profiling.merge_summaries(a, b)
    assert merged == {
        "solve": {"total_s": 5.0, "self_s": 3.5, "count": 2, "max_s": 3.0,
                  "parent": None},
        "solve.capture": {"total_s": 0.75, "self_s": 0.75, "count": 2,
                          "max_s": 0.5, "parent": "solve", "segments": 4},
        "solve.replay": b["solve.replay"]}
    assert a["solve"]["count"] == 1            # the inputs stay as they were


def test_quad_adapt_merges_the_resolves_spans(monkeypatch):
    """`_quad_adapt_resolve` adds each re-solve's spans to the first
    solve's, as it adds their graph counts."""
    discretize = importlib.import_module(
        "neuralpde_tpu_torch.compile.discretize")

    def summary(seconds):
        return {"solve": {"total_s": seconds, "self_s": seconds, "count": 1,
                          "max_s": seconds, "parent": None}}

    class Strategy:
        def __init__(self):
            self.checks = iter([False, True, True])
            self._trained_checks = []

        def validate_trained(self, u, warn=True):
            return [{"ok": next(self.checks)}]

    class Problem:
        def __init__(self, loss, init_params, pinnrep):
            self.pinnrep = pinnrep

    def resolve(prob, optimizer, **kw):
        return train.SolveResult(u={}, objective=0.5, iterations=4,
                                 aux={"spans": summary(3.0)}, history=[0.5])

    monkeypatch.setattr(discretize, "rebuild_strategy_losses",
                        lambda pinnrep, at_params: None)
    monkeypatch.setattr(train, "solve", resolve)
    first = train.SolveResult(u={}, objective=1.0, iterations=4,
                              aux={"spans": summary(2.0)}, history=[1.0])
    strategy = Strategy()
    res = train._quad_adapt_resolve(
        first, Problem(None, {}, object()), strategy, None, 4, rounds=2,
        abstol=None, generator=None, inner_steps=2, verbose=False)
    assert res.iterations == 8
    assert res.aux["spans"]["solve"] == {"total_s": 5.0, "self_s": 5.0,
                                         "count": 2, "max_s": 3.0,
                                         "parent": None}

"""Each traffic driver run on the CPU for two seconds at a small size:
the contract's last line with no device metric, ``correct`` true, and
``correct`` false when the program underneath is broken."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import _bench_setup as setup

import numpy as np
import pytest
import torch

import run

ONE_CARD = ("dense-w64-b2m", "spinn-r64-g16384", "dense-w64-hard-to-target")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _line(name, seed, seconds=2, **kw):
    line = run.run_cell(name, seed, seconds, False, device="cpu",
                        overrides=setup.SMALL[name], **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.emit(line) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ONE_CARD)
def test_a_two_second_run_prints_the_line(name):
    line = _line(name, 2**31 + 11)
    assert list(line) == KEYS
    assert line["correct"] is True
    assert line["metrics"] == {}
    assert line["device"]["platform"] == "cpu"
    assert "busy_s" not in line["device"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


@pytest.fixture
def unchanged_state(monkeypatch):
    """Adam's step updates its moments and leaves the parameters as they
    were."""
    import neuralpde_tpu_torch.train as train

    step = train.Adam.step

    def still(self, closure=None):
        kept = [p.detach().clone() for g in self.param_groups
                for p in g["params"]]
        step(self, closure)
        with torch.no_grad():
            for p, k in zip((p for g in self.param_groups
                             for p in g["params"]), kept):
                p.copy_(k)

    monkeypatch.setattr(train.Adam, "step", still)


@pytest.fixture
def half_batch(monkeypatch):
    """Each draw's second half repeats its first: the mean is taken over
    half of the batch."""
    import neuralpde_tpu_torch.compile.separable as separable
    import neuralpde_tpu_torch.strategies as strategies

    draw = strategies.uniform_random

    def half(points, lb, ub, generator, **kw):
        pts = draw(points, lb, ub, generator, **kw)
        return torch.cat([pts[:, :points // 2]] * 2, dim=1)[:, :points]

    monkeypatch.setattr(strategies, "uniform_random", half)
    nodes = separable.static_axis_nodes

    def half_rows(*a, **kw):
        out = nodes(*a, **kw)
        first = next(iter(out))
        n = len(out[first])
        out[first] = np.concatenate([out[first][:n // 2]] * 2)[:n]
        return out

    monkeypatch.setattr(separable, "static_axis_nodes", half_rows)


@pytest.mark.parametrize("name", ONE_CARD)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        name, unchanged_state):
    assert _line(name, 5, seconds=1)["correct"] is False


@pytest.mark.parametrize("name", ONE_CARD)
def test_half_of_the_batch_left_out_is_not_correct(name, half_batch):
    assert _line(name, 6, seconds=1)["correct"] is False


def test_data_parallel_run_prints_the_line():
    line = _line("dense-w64-b2m-dp4", 7)
    assert list(line) == KEYS
    assert line["correct"] is True and line["device"]["count"] == 2


def test_data_parallel_without_the_exchange_is_not_correct():
    fault = os.path.join(os.path.dirname(__file__), "_bench_no_exchange.py")
    assert _line("dense-w64-b2m-dp4", 8, seconds=1,
                 preload=fault)["correct"] is False


def test_without_a_card_the_command_prints_nothing_and_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dense-w64-b2m",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=setup.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_with_only_the_benchmark_files_a_run_fails(tmp_path):
    shutil.copy(os.path.join(setup.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(setup.BENCH, tmp_path / "benchmark")
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "print(run.run_cell('dense-w64-b2m', 1, 1, False, "
            "device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""

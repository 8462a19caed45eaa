"""The (3+1)-D Beltrami SPINN of the port against the benchmark's plain
reference (`benchmark/reference/beltrami.py`), and what the separable
strategy records while it builds the losses: each loss's route and grid
contractions, and the span ``separable.build``.  CPU, float64, at nodes
(5, 4, 4, 3) so that an axis mix-up shows."""

import ast
import importlib.util
import math
import os

import pytest
import torch

from neuralpde_tpu_torch.compile import separable
from neuralpde_tpu_torch.examples import beltrami_spinn as ex
from neuralpde_tpu_torch.utils import profiling

F64 = torch.float64
NODES = (5, 4, 4, 3)
REFERENCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "reference", "beltrami.py")


def _reference():
    spec = importlib.util.spec_from_file_location("bench_ref_beltrami",
                                                  REFERENCE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _init(seed=7):
    """Seeded ``mlp([1, 8, 8, 4])`` leaves of the 16 axis nets under the
    benchmark's names, with biases that are not zero."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for f in "uvwp":
        for a in range(4):
            for i, (m, n) in enumerate(zip([1, 8, 8], [8, 8, 4])):
                limit = math.sqrt(6 / (m + n))
                out[f"{f}.axis_{a}.layer_{i}.weight"] = limit * (
                    2 * torch.rand(n, m, generator=gen, dtype=F64) - 1)
                out[f"{f}.axis_{a}.layer_{i}.bias"] = 0.1 * torch.randn(
                    n, 1, generator=gen, dtype=F64)
    return out


def _problem(eps, init=None):
    return ex.make_problem(ex.make_nets(4, 8, F64), eps, nodes=NODES,
                           dtype=F64, device="cpu", init_params=init)


@pytest.mark.parametrize("eps", [1.0, 30.0])
def test_beltrami_loss_and_gradients_match_the_plain_reference(eps):
    init = _init()
    prob = _problem(eps, init)
    theta = {k: v.clone().requires_grad_(True)
             for k, v in prob.init_params.items()}
    ada = prob.pinnrep.adaloss.init_state(4, 22, F64, "cpu")
    loss, _ = prob.loss(theta, {"generator": torch.Generator(),
                                "adaptive": ada})
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    want, grads = _reference().loss_and_grads(params, NODES, eps, F64, F64)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-10)
    assert len(grads) == 96
    for k, g in grads.items():
        got = theta[f"depvar.{k}"].grad
        assert torch.allclose(got, g, rtol=1e-10,
                              atol=1e-10 * float(g.abs().max())), k


def test_each_loss_records_its_route_and_grid_contractions():
    """Each momentum equation forms u, v, w, its field's seven derivatives
    and one pressure gradient; continuity u_x, v_y, w_z; each three-axis
    condition one grid; the gauge's one-axis contraction is no grid."""
    strategy = _problem(1.0).pinnrep.strategy
    assert strategy.routes == ["grid"] * 26
    assert strategy.grid_contractions == [11, 11, 11, 3] + [1] * 21 + [0]
    assert sum(strategy.grid_contractions) == 57


def test_the_build_span_is_recorded_only_with_spans_on(monkeypatch):
    before = profiling.spans_enabled()
    try:
        profiling.enable_spans(False)

        def no_timer():
            raise AssertionError("a PhaseTimer was made with spans off")

        with monkeypatch.context() as m:
            m.setattr(separable, "PhaseTimer", no_timer)
            assert _problem(1.0).pinnrep.strategy.spans is None
        profiling.enable_spans(True)
        spans = _problem(1.0).pinnrep.strategy.spans
    finally:
        profiling.enable_spans(before)
    assert list(spans) == ["separable.build"]
    assert spans["separable.build"]["count"] == 1
    assert spans["separable.build"]["parent"] is None
    assert spans["separable.build"]["total_s"] > 0


def test_the_reference_imports_only_torch_and_numpy():
    tops = set()
    for node in ast.walk(ast.parse(open(REFERENCE).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "numpy", "torch"}, tops

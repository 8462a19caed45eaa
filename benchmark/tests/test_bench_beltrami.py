"""The Beltrami SPINN configuration: its plain reference against the
program at a tiny size on the CPU in float64 (nodes (5, 4, 4, 3), so that
an axis mix-up shows), its driver's set-up on the CPU, its counts against
hand arithmetic, and on the card the TF32 control failing the comparison.
"""

import ast
import json
import os

import _bench_setup as setup

import pytest
import torch

import problem_beltrami
import problems
import run
from reference import beltrami, compare, flops

CELL = "spinn-beltrami-r64-g65"
TINY = {"grid": [5, 4, 4, 3], "axis_layers": [1, 8, 8, 4], "rank": 4}


def _config(**over):
    return {**run.read_json(os.path.join(setup.BENCH, "configs",
                                         "spinn-beltrami-r64.json")), **over}


@pytest.mark.parametrize("eps", [1.0, 30.0])
def test_the_reference_matches_the_program_in_float64(eps):
    problem = _config(**TINY, dtype="float64",
                      sampling={"causal": "t", "causal_eps": eps})
    init = problem_beltrami.init_params(problem, 11, "cpu")
    # biases that are not zero, so that their path is held too
    gen = torch.Generator().manual_seed(12)
    init = {k: v + 0.1 * torch.randn(v.shape, generator=gen,
                                     dtype=torch.float64)
            if k.endswith(".bias") else v for k, v in init.items()}
    prob = problem_beltrami.build(run.import_program(), problem, init, "cpu")
    theta = {k: v.clone().requires_grad_(True)
             for k, v in prob.init_params.items()}
    ada = prob.pinnrep.adaloss.init_state(4, 22, torch.float64, "cpu")
    loss, _ = prob.loss(theta, {"generator": torch.Generator(),
                                "adaptive": ada})
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    want, grads = beltrami.loss_and_grads(params, TINY["grid"], eps,
                                          torch.float64, torch.float64)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-10)
    assert len(grads) == 96
    for k, g in grads.items():
        got = theta[problems.PREFIX + k].grad
        assert torch.allclose(got, g, rtol=1e-10,
                              atol=1e-10 * float(g.abs().max())), k


def test_the_driver_runs_the_cell_on_the_cpu():
    line = run.run_cell(CELL, 2**31 + 13, 1, False, device="cpu",
                        overrides={"config": TINY})
    assert line["correct"] is True, line["checks"]
    assert line["metrics"] == {} and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["checks"]) == set(compare.NAMES)


def test_counted_points_and_model_flops_at_65():
    problem = _config()
    n = 65
    assert problem_beltrami.counted_points(problem) == (
        n ** 4 + 21 * n ** 3 + n) == 23_617_815
    axis = flops.layer_flops([1, 64, 64, 64])
    # u, v, w: 3 columns on x, y, z and 2 on t; p: 2 and 1; 24 constants
    columns = 3 * n * (3 + 3 + 3 + 2) + n * (2 + 2 + 2 + 1) + 24
    forward = 27 * 2 * 64 * n ** 4 + 2 * 64 * (21 * n ** 3 + n) \
        + axis * columns
    assert problem_beltrami.model_flops(problem) == 3 * forward


def test_the_reference_imports_only_torch_and_numpy():
    path = os.path.join(setup.BENCH, "reference", "beltrami.py")
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "numpy", "torch"}, tops


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct():
    """The reference in TF32 put in the program's place, against the
    float64 reference, on three seeds at 33 nodes an axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 runs only there")
    with open(os.path.join(setup.BENCH, "workloads", f"{CELL}.json")) as f:
        workload = json.load(f)
    problem = _config(grid=33)
    for seed in (1, 2, 3):
        init = problem_beltrami.init_params(
            problem, problems.seeds(seed, 2)[0], "cuda")
        steps = workload["check_steps"]
        want = problem_beltrami.follow_reference(problem, init, steps)
        got = problem_beltrami.follow_reference(problem, init, steps,
                                                torch.float32, tf32=True)
        correct, checks = compare.judge(compare.readings(got, want),
                                        workload["limits"])
        assert not correct, (seed, checks)

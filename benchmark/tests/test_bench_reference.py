"""The plain reference against the program at a tiny size on the CPU: the
same loss and gradients from the same parameters and points."""

import _bench_setup as setup

import pytest
import torch

import problems
import run
from reference import dense, spinn


def _program_loss_and_grads(npde, problem, init, points_seed):
    prob = problems.build(npde, problem, init, "cpu")
    theta = {k: v.clone().requires_grad_(True)
             for k, v in prob.init_params.items()}
    ada = prob.pinnrep.adaloss.init_state(1, 4 if problem.get(
        "trial_function") == "dense" else 0, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(points_seed)
    loss, _ = prob.loss(theta, {"generator": gen, "adaptive": ada})
    loss.backward()
    return float(loss.detach()), {k[len(problems.PREFIX):]: v.grad
                         for k, v in theta.items()}


def _close(got, want, rtol):
    loss, grads = got
    ref_loss, ref_grads = want
    assert loss == pytest.approx(ref_loss, rel=rtol)
    for k, g in ref_grads.items():
        assert torch.allclose(grads[k].double(), g.double(), rtol=rtol,
                              atol=rtol * float(g.abs().max())), k


@pytest.mark.parametrize("hard_box,microbatch", [(False, 256), (True, None)])
def test_dense_reference_matches_the_program(hard_box, microbatch):
    npde = run.import_program()
    problem = {**run.read_json(f"{setup.BENCH}/configs/"
                               "dense-poisson-w64.json"),
               "hard_box": hard_box,
               "sampling": {"points": 1024, "bcs_points": 128,
                            "microbatch": microbatch}}
    init = problems.init_params(problem, 3, "cpu")
    got = _program_loss_and_grads(npde, problem, init, 5)
    params = {k: v.double().requires_grad_(True) for k, v in init.items()}
    pts = dense.draw_points(torch.Generator().manual_seed(5), 1024, 128,
                            "cpu")
    want = dense.loss_and_grads(params, pts, problem["layers"], hard_box,
                                torch.float64)
    _close(got, want, 1e-4)


def test_separable_reference_matches_the_program():
    npde = run.import_program()
    problem = {**run.read_json(f"{setup.BENCH}/configs/"
                               "spinn-poisson-r64.json"), "grid": 48}
    init = problems.init_params(problem, 4, "cpu")
    got = _program_loss_and_grads(npde, problem, init, 0)
    params = {k: v.double().requires_grad_(True) for k, v in init.items()}
    want = spinn.loss_and_grads(params, problem["axis_layers"], 48,
                                torch.float64)
    _close(got, want, 1e-4)


def test_rms_error_of_the_exact_solution_is_nought():
    # a net whose output is 0 everywhere has the solution's RMS as error
    layers = [2, 4, 1]
    params = {"layer_0.weight": torch.zeros(4, 2),
              "layer_0.bias": torch.zeros(4, 1),
              "layer_1.weight": torch.zeros(1, 4),
              "layer_1.bias": torch.zeros(1, 1)}
    err = dense.rms_error(params, layers, True, 51)
    xs = torch.linspace(0, 1, 51, dtype=torch.float64)
    s = torch.sin(torch.pi * xs)
    want = float(torch.sqrt(((s[:, None] * s[None, :]) ** 2).mean())
                 / (2 * torch.pi ** 2))
    assert err == pytest.approx(want, rel=1e-12)

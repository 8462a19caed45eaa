"""The port's `solve` around the step: checkpoint/resume, `solve_hybrid`
(Adam, then L-BFGS), profiling, logging, the default device, and
`quad_adapt` where there is no rule to adapt; on the CPU (the CUDA-graph path is in
tests/test_torch_cuda.py).

A resumed run is compared bit for bit with one that never stopped.
`solve_hybrid` is held to the JAX package's `solve_hybrid` by the error band
on the 1-D Poisson flow: the two L-BFGS implementations take other steps.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_1d, poisson_2d
from neuralpde_tpu_torch.utils import checkpoint, profiling

F64 = torch.float64


def _prob(strategy, sizes=(2, 8, 8, 1), adaloss=None, seed=0, dtype=F64):
    tree = mlp_params(np.random.default_rng(seed), list(sizes))
    return tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(list(sizes), dtype=dtype), strategy,
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=dtype,
        adaptive_loss=adaloss, device="cpu"))


def test_physics_informed_nn_defaults_to_cuda():
    disc = tpkg.PhysicsInformedNN(tpkg.mlp([2, 8, 1]), tpkg.GridTraining(0.5))
    assert disc.device == torch.device("cuda")
    cpu = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([2, 8, 1]), tpkg.GridTraining(0.5), device="cpu"))
    assert cpu.pinnrep.device == torch.device("cpu")
    assert all(v.device.type == "cpu" for v in cpu.init_params.values())


@pytest.mark.parametrize("optimizer,dtype", [
    ("adam", F64), ("adam", torch.float32), ("lbfgs", F64)])
def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(tmp_path, optimizer,
                                                          dtype):
    """Stochastic points and reweighting: the checkpoint carries the
    parameters, the optimizer's state (Adam's step count stays float64 in
    a float32 problem), the generator and the weights."""
    opt = tpkg.adam(1e-2) if optimizer == "adam" else tpkg.lbfgs()

    def prob():
        return _prob(tpkg.StochasticTraining(32, bcs_points=8),
                     adaloss=tpkg.SoftAdaptAdaptiveLoss(3), dtype=dtype)

    straight = tpkg.solve(prob(), opt, maxiters=12, inner_steps=2)
    first = tpkg.solve(prob(), opt, maxiters=6, inner_steps=2,
                       checkpoint_dir=str(tmp_path))
    assert first.iterations == 6
    resumed = tpkg.solve(prob(), opt, maxiters=12, inner_steps=2,
                         checkpoint_dir=str(tmp_path))
    assert resumed.iterations == 12 and len(resumed.history) == 3
    assert resumed.objective == straight.objective
    for k, v in straight.u.items():
        assert torch.equal(resumed.u[k], v), k
    for k, v in straight.aux["adaptive_state"].items():
        assert torch.equal(resumed.aux["adaptive_state"][k], v), k
    assert sorted(os.listdir(tmp_path)) == [
        "adaptive.npz", "generator.npz", "meta.json", "opt_state.npz",
        "params.npz"]
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["iteration"] == 12


def test_mismatched_restore_raises(tmp_path):
    prob = _prob(tpkg.GridTraining(0.5))
    tpkg.solve(prob, maxiters=2, checkpoint_dir=str(tmp_path))
    for sizes, match in (((2, 8, 1), "names do not match"),
                         ((2, 8, 6, 1), "has shape")):
        other = _prob(tpkg.GridTraining(0.5), sizes=sizes)
        with pytest.raises(ValueError, match=match):
            tpkg.solve(other, maxiters=4, checkpoint_dir=str(tmp_path))
    theta = {k: v.clone() for k, v in prob.init_params.items()}
    _, _, it = checkpoint.restore_checkpoint(str(tmp_path), theta)
    assert it == 2
    assert not torch.equal(theta["depvar.layer_0.weight"],
                           prob.init_params["depvar.layer_0.weight"])


def test_solve_hybrid_reaches_the_jax_band():
    """1-D Poisson: the L-BFGS stage takes the error below the Adam stage's,
    into the band of the JAX package's `solve_hybrid` from the same start."""
    tree = mlp_params(np.random.default_rng(4), [1, 16, 1])
    jprob = jpkg.discretize(poisson_1d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([1, 16, 1]), jpkg.GridTraining(0.05), init_params=tree,
        derivative="jet"))
    tprob = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 16, 1], dtype=F64), tpkg.GridTraining(0.05),
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=F64,
        device="cpu"))
    xs = np.linspace(0, 1, 101)[None, :]

    def err(u):
        got = tprob.pinnrep.phi(torch.tensor(xs), tpkg.depvar_params(u))
        return float(np.max(np.abs(got.numpy() - np.sin(np.pi * xs))))

    kw = dict(adam_iters=300, lbfgs_iters=100, adam_lr=2e-2, inner_steps=50)
    adam_only = tpkg.solve(tprob, tpkg.adam(2e-2), maxiters=300,
                           inner_steps=50)
    hybrid = tpkg.solve_hybrid(tprob, **kw)
    jhybrid = jpkg.solve_hybrid(jprob, **kw)
    jerr = float(np.max(np.abs(np.asarray(jprob.pinnrep.phi(
        xs, jhybrid.u["depvar"])) - np.sin(np.pi * xs))))
    assert hybrid.iterations == 400 and len(hybrid.history) == 8
    # measured: Adam 1.15e-2 (both packages), hybrid 1.19e-3, JAX 2.33e-3
    assert err(hybrid.u) < 0.25 * err(adam_only.u)
    assert jerr / 3 < err(hybrid.u) < 3 * jerr


def test_profiling_helpers(tmp_path):
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("step"):
            pass
    assert timer.summary()["step"]["count"] == 3
    checked = profiling.checkify_residual(lambda x: torch.log(x))
    assert torch.equal(checked(torch.ones(3)), torch.zeros(3))
    with pytest.raises(FloatingPointError, match="non-finite"):
        checked(torch.tensor([1.0, -1.0]))
    before = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debugging(before)
    tpkg.solve(_prob(tpkg.GridTraining(0.5)), maxiters=2,
               profile_dir=str(tmp_path))
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_logger_gets_losses_and_weights_at_the_log_frequency(tmp_path,
                                                             monkeypatch):
    class Recorder:
        def __init__(self):
            self.names = []

        def log_scalar(self, name, value, step):
            self.names.append((name, step))

    rec = Recorder()
    prob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([2, 8, 1], dtype=F64), tpkg.GridTraining(0.5), dtype=F64,
        logger=rec, log_options=tpkg.LogOptions(log_frequency=2),
        device="cpu"))
    tpkg.solve(prob, maxiters=4)
    assert ("adaptive_loss/bc_loss_weights/4", 4) in rec.names
    assert {s for _, s in rec.names} == {2, 4}

    tb = tpkg.TensorBoardLogger(str(tmp_path / "tb"))
    tb.log_scalar("a", 1.0, 0)
    tb.close()
    assert os.listdir(tmp_path / "tb")
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.warns(UserWarning, match="no-op"):
        quiet = tpkg.TensorBoardLogger(str(tmp_path / "none"))
    quiet.log_scalar("a", 1.0, 0)


def test_quad_adapt_waits_for_the_quadrature_slice():
    """It waited; now `quad_adapt` is accepted, and without an auto-refined
    `QuadratureTraining` rule to check it changes nothing
    (tests/test_torch_integrals.py has the cases where it acts)."""
    plain = tpkg.solve(_prob(tpkg.GridTraining(0.5)), maxiters=2)
    res = tpkg.solve(_prob(tpkg.GridTraining(0.5)), maxiters=2,
                     quad_adapt=True)
    assert res.iterations == 2 and res.history == plain.history


def test_make_step_computes_component_gradients_for_the_schemes():
    prob = _prob(tpkg.GridTraining(0.5),
                 adaloss=tpkg.GradientScaleAdaptiveLoss(1))
    lf = prob.pinnrep.loss_functions
    step = tpkg.make_step(prob.loss, tpkg.adam(1e-3), prob.pinnrep.adaloss,
                          lf.pde_loss_functions, lf.bc_loss_functions)
    ada = prob.pinnrep.adaloss.init_state(1, 4, F64, "cpu")
    carry = step.init(prob.init_params, ada)
    carry, _ = step(carry, torch.Generator())
    # every step reweights: the BC weights left 1
    assert not torch.equal(carry[2]["bc_weights"], torch.ones(4, dtype=F64))
    assert torch.equal(ada["bc_weights"], torch.ones(4, dtype=F64))
    assert carry[3] == 1

"""The port's measurement scripts (`scripts/torch_*.py`, the twins of the
JAX package's TPU scripts) on the CPU.

* Each twin's problem builder against its JAX script's own, run unedited:
  the JAX script is loaded by path and its builder called with the JAX
  package's `PhysicsInformedNN` set to float64 (and, for a script that
  builds inside the function that trains, `discretize` stopped at its
  first call); the JAX parameters cross with `params_from_jax`, and each
  equation's loss and gradient norm agree within 1e-9 relative in float64
  (1e-7 for the weak rows, whose orders are at most 2; plus 1e-14
  absolute for the periodic conditions that hold by construction), on the
  JAX package's points where the strategy draws them.
* The JSON keys of each JAX script that prints JSON are among its twin's.
* The breakdown's classifier on fixed kernel names, and `breakdown()` on a
  synthetic trace: classes, busy time, idle gaps and the host operation
  open at each, and the check that the classes sum to the busy time.
* Each twin defaults to the card and raises without one.
"""

import ast
import contextlib
import dataclasses
import faulthandler
import importlib.util
import inspect
import math
import pathlib
import signal
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import tree_like
from neuralpde_tpu.ops import sampling as jsampling

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
TWINS = ("torch_profile_breakdown", "torch_measure_weak",
         "torch_measure_weak_accuracy", "torch_measure_ensemble",
         "torch_measure_mfu_accuracy", "torch_probe_tr_parity",
         "torch_probe_allen_cahn_budget", "torch_measure_ns_operator",
         "torch_measure_pino_pde", "torch_measure_fieldgrid_derivs")
# JAX configuration the JAX scripts set when imported, put back after
_JAX_CONFIG = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs", "jax_enable_x64")


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _twin(name: str):
    return _load(ROOT / "scripts" / f"{name}.py", name)


@contextlib.contextmanager
def _jax_config_kept():
    """Put back the JAX configuration that a JAX script or example sets
    when imported (its compilation cache)."""
    saved = {k: getattr(jax.config, k) for k in _JAX_CONFIG}
    try:
        yield
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _jax_script(name: str, monkeypatch):
    """``scripts/<name>.py`` of the JAX package, loaded by path; what it
    sets at import (JAX's compilation cache, a signal handler, sys.path)
    is put back."""
    monkeypatch.setattr(sys, "path", [str(ROOT / "examples"), *sys.path])
    with _jax_config_kept():
        module = _load(ROOT / "scripts" / f"{name}.py", f"jax_{name}")
    if name == "measure_mfu_accuracy":
        faulthandler.unregister(signal.SIGUSR1)
    return module


class _Built(Exception):
    """Carries the problem of a JAX script's first `discretize`."""


def _float64_build(monkeypatch, script, stop: bool = False):
    """The JAX package's `PhysicsInformedNN` in float64 for ``script`` (and
    its `discretize` raising `_Built` with the problem, if ``stop``; its
    `solve_pino_pde` raises `_Built` with the system and operator)."""
    pinn, discretize = jpkg.PhysicsInformedNN, jpkg.discretize

    def float64_pinn(*args, **kw):
        return pinn(*args, **{**kw, "dtype": jnp.float64})

    def stopped(*args, **kw):
        raise _Built(discretize(*args, **kw))

    def pino_stopped(system, alg, **kw):
        raise _Built((system, alg))

    patches = {"PhysicsInformedNN": float64_pinn,
               "solve_pino_pde": pino_stopped}
    if stop:
        patches["discretize"] = stopped
    for name, fn in patches.items():
        monkeypatch.setattr(jpkg, name, fn)
        if hasattr(script, name):
            monkeypatch.setattr(script, name, fn)


def _first_problem(call):
    with _jax_config_kept(), pytest.raises(_Built) as info:
        call()
    return info.value.args[0]


def _init(jprob) -> dict:
    """The JAX problem's parameters for the port (float64)."""
    tree = jax.tree.map(np.asarray, jprob.init_params["depvar"])
    assert all(leaf.dtype == np.float64 for leaf in jax.tree.leaves(tree))
    return tpkg.params_from_jax(tree, dtype=F64)


def _fns(prob):
    lf = prob.pinnrep.loss_functions
    return lf.pde_loss_functions + lf.bc_loss_functions


def _norm(grads) -> float:
    return math.sqrt(sum(float(np.sum(np.square(np.asarray(g))))
                         for g in grads))


def _jax_sampler(key):
    """A port sampler that draws what the JAX strategy draws with ``key``
    between the bounds the port's strategy gives it."""
    def sampler(n, lb, ub, generator):
        return torch.tensor(np.asarray(jsampling.uniform_random(
            key, n, jnp.asarray(lb.numpy()), jnp.asarray(ub.numpy()),
            dtype=jnp.float64)))

    return sampler


def _close(got: float, want: float, rtol: float) -> bool:
    # 1e-14 absolute: a periodic condition that the periodic embedding
    # meets by construction has a loss of rounding noise (~1e-31)
    return abs(got - want) <= rtol * abs(want) + 1e-14


def _equations_agree(jprob, tprob, rtol: float, drawn: bool,
                     count: int | None = None) -> None:
    """Each equation's loss and gradient norm (of the first ``count``),
    the JAX package's against the port's from the same parameters (and,
    where the strategy draws them, the same points, fed through the port's
    ``sampler``)."""
    assert len(_fns(jprob)) == len(_fns(tprob))
    jfns = _fns(jprob)[:count]
    keys = [jax.random.key(20 + i) for i in range(len(jfns))]
    wants = jax.jit(lambda theta: [
        jax.value_and_grad(f)(theta, k)
        for f, k in zip(jfns, keys)])(jprob.init_params)
    for i, (tfn, key, (want, jgrad)) in enumerate(zip(_fns(tprob), keys,
                                                       wants)):
        if drawn:
            tprob.pinnrep.strategy.sampler = _jax_sampler(key)
        theta = {k: v.clone().requires_grad_(True)
                 for k, v in tprob.init_params.items()}
        got = tfn(theta, None)
        grads = torch.autograd.grad(got, list(theta.values()),
                                    materialize_grads=True)
        assert _close(float(got.detach()), float(want), rtol), i
        assert _close(_norm(grads), _norm(jax.tree.leaves(jgrad)), rtol), i


# --------------------------------------------------------------------------
# the builders against the JAX scripts'
# --------------------------------------------------------------------------

def test_profile_breakdown_builders_match_jax(monkeypatch):
    script = _jax_script("profile_breakdown", monkeypatch)
    twin = _twin("torch_profile_breakdown")
    _float64_build(monkeypatch, script)
    jprob, jpoints = script.build_dense(64, 32, 8)
    tprob, points = twin.build_dense(64, 32, 8, dtype=F64, device="cpu",
                                     init_params=_init(jprob))
    assert points == jpoints == 64 + 4 * 8
    # the PDE and one side: the others are bench's, which
    # tests/test_torch_bench.py holds to the JAX package one by one
    _equations_agree(jprob, tprob, 1e-9, drawn=True, count=2)
    jprob, jpoints = script.build_spinn(n=16, rank=4, hidden=8)
    tprob, points = twin.build_spinn(16, 4, 8, dtype=F64, device="cpu",
                                     init_params=_init(jprob))
    assert points == jpoints == 256
    _equations_agree(jprob, tprob, 1e-9, drawn=False)


@pytest.mark.parametrize("ibp", [0, None], ids=["weak_ibp0", "strong"])
def test_measure_weak_builder_matches_jax(monkeypatch, ibp):
    """`measure_weak_tpu.measure`'s problem, on a 2-element mesh (the same
    strategy given to both; the builder does not see ibp, which
    tests/test_torch_weak.py holds at 0, 1 and 2)."""
    script = _jax_script("measure_weak_tpu", monkeypatch)
    twin = _twin("torch_measure_weak")
    _float64_build(monkeypatch, script, stop=True)

    def strategy(pkg):
        if ibp is None:
            return pkg.GridTraining(1.0 / 7)
        return pkg.WeakTraining(elements=2, n_test=3, quad=4, ibp=ibp,
                                bc_dx=1.0 / 7)

    jprob = _first_problem(lambda: script.measure(lambda: strategy(jpkg),
                                                  "toy"))
    tprob = twin.build(strategy(tpkg), dtype=F64, device="cpu",
                       init_params=_init(jprob))
    _equations_agree(jprob, tprob, 1e-9 if ibp is None else 1e-7,
                     drawn=False)


@pytest.mark.parametrize("kind", ["smooth", "front"])
def test_measure_weak_accuracy_builder_matches_jax(monkeypatch, kind):
    script = _jax_script("measure_weak_accuracy_tpu", monkeypatch)
    twin = _twin("torch_measure_weak_accuracy")
    _float64_build(monkeypatch, script)
    for name, kw, rtol in (("GridTraining", dict(dx=1.0 / 7), 1e-9),
                           ("WeakTraining", dict(elements=2, n_test=3, quad=4,
                                                 ibp=1), 1e-7)):
        _, _, jprob, exact = script.build_problem(
            kind, getattr(jpkg, name)(**kw), 0)
        _, _, tprob = twin.build_problem(kind, getattr(tpkg, name)(**kw), 0,
                                         dtype=F64, device="cpu",
                                         init_params=_init(jprob))
        _equations_agree(jprob, tprob, rtol, drawn=False)
    X, Y = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 1, 5))
    np.testing.assert_array_equal(twin.exact(kind, X, Y), exact(X, Y))


def test_measure_ensemble_builder_matches_jax(monkeypatch):
    script = _jax_script("measure_ensemble_tpu", monkeypatch)
    twin = _twin("torch_measure_ensemble")
    _float64_build(monkeypatch, script)
    jprob = script.poisson_prob()
    tprob = twin.poisson_prob(dtype=F64, device="cpu",
                              init_params=_init(jprob))
    _equations_agree(jprob, tprob, 1e-9, drawn=False)


def _no_ground_truth(monkeypatch, *modules):
    """The JAX example's spectral reference (0.8 s), which the scripts
    compute before they build, replaced by a small array: the builders do
    not read it."""
    import allen_cahn_spinn

    def ground_truth():
        return np.linspace(-1, 1, 4), np.linspace(0, 1, 3), np.zeros((3, 4))

    for module in (allen_cahn_spinn, *modules):
        monkeypatch.setattr(module, "ground_truth", ground_truth)


def test_measure_mfu_accuracy_builder_matches_jax(monkeypatch):
    """The JAX script's stage-1 problem of a toy row (width 8, batch 64)."""
    script = _jax_script("measure_mfu_accuracy", monkeypatch)
    _no_ground_truth(monkeypatch)
    twin = _twin("torch_measure_mfu_accuracy")
    _float64_build(monkeypatch, script, stop=True)
    monkeypatch.setattr(sys, "argv", ["measure_mfu_accuracy.py", "--rows",
                                      "8:64", "--inner", "2"])
    monkeypatch.setattr(script, "_log", lambda msg: None)
    jprob = _first_problem(script.main)
    tprob = twin.make_problem(8, 64, twin.STAGES[0][0], dtype=F64,
                              device="cpu", init_params=_init(jprob))
    assert jprob.pinnrep.strategy.causal_eps == twin.STAGES[0][0]
    _equations_agree(jprob, tprob, 1e-9, drawn=True)


def test_probe_tr_parity_builder_matches_jax(monkeypatch):
    script = _jax_script("probe_tr_parity", monkeypatch)
    twin = _twin("torch_probe_tr_parity")
    _float64_build(monkeypatch, script)
    jprob, _ = script.build()
    tprob, _ = twin.build(dtype=F64, device="cpu", init_params=_init(jprob))
    _equations_agree(jprob, tprob, 1e-9, drawn=False)


def test_probe_allen_cahn_budget_builder_matches_jax(monkeypatch):
    """The JAX script's first stage at rank 4 on 8 nodes an axis."""
    script = _jax_script("probe_allen_cahn_budget", monkeypatch)
    _no_ground_truth(monkeypatch, script)
    twin = _twin("torch_probe_allen_cahn_budget")
    _float64_build(monkeypatch, script, stop=True)
    stages = [(100.0, 1e-3)]
    jprob = _first_problem(lambda: script.run("highest", 1, stages, rank=4,
                                              nodes=8))
    tprob = twin.make_problem(tpkg.accuracy.allen_cahn_net(4, dtype=F64),
                              twin.STAGES[0][0], nodes=8, dtype=F64,
                              device="cpu")
    tprob = tprob.with_params({f"depvar.{k}": v
                               for k, v in _init(jprob).items()})
    _equations_agree(jprob, tprob, 1e-9, drawn=False)


def _pino_agree(jpair, tpair, draws=None, seed: int = 0) -> None:
    """The loss and gradient of a JAX script's operator against its twin's
    from the same parameters (and input-function family ``draws``)."""
    from neuralpde_tpu.solvers import pino_pde as jpde
    from neuralpde_tpu_torch.solvers import pino_pde as tpde

    (jsystem, jalg), (tsystem, talg) = jpair, tpair
    if draws is not None:
        (jcall,), (tcall,) = jalg.input_functions, talg.input_functions
        jalg = dataclasses.replace(jalg, input_functions={
            jcall: lambda key, grids, n: jnp.asarray(draws)})
        talg = dataclasses.replace(talg, input_functions={
            tcall: lambda gen, grids, n: torch.tensor(draws)})
    tree = tree_like(jax.eval_shape(jalg.chain.init, jax.random.key(0)),
                     np.random.default_rng(seed), 0.3)
    jb = jpde._build(jsystem, jalg)
    tb = tpde._build(tsystem, talg, device="cpu")
    want, jgrad = jax.jit(jax.value_and_grad(lambda th: jb.total_loss(
        th, jax.random.key(0))))({"depvar": jax.tree.map(jnp.asarray, tree)})
    theta = {f"depvar.{k}": v.requires_grad_(True) for k, v in
             tpkg.params_from_jax(tree, dtype=F64).items()}
    got = tb.total_loss(theta, None)
    grads = torch.autograd.grad(got, list(theta.values()))
    assert _close(float(got.detach()), float(want), 1e-9)
    assert _close(_norm(grads), _norm(jax.tree.leaves(jgrad)), 1e-9)


@pytest.fixture
def float64_default():
    """The PINO solvers work in the default float dtype."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(before)


@pytest.mark.usefixtures("float64_default")
def test_measure_ns_operator_builder_matches_jax(monkeypatch):
    """`measure_ns_operator_tpu.run_row`'s operator at a toy spectral row
    (9^2 x 5 grid, FNO3D w6 m(3,3,2)) added to both scripts' rows."""
    script = _jax_script("measure_ns_operator_tpu", monkeypatch)
    twin = _twin("torch_measure_ns_operator")
    _float64_build(monkeypatch, script)
    row = (8, 4, 6, (3, 3, 2), 0.01, True)
    monkeypatch.setitem(script.ROWS, "toy", row)
    monkeypatch.setitem(twin.ROWS, "toy", row)
    jpair = _first_problem(lambda: script.run_row("toy", 1, None))
    draws = np.random.default_rng(8).normal(size=(9, 9, 12))
    _pino_agree(jpair, twin.build("toy"), draws)


@pytest.mark.usefixtures("float64_default")
def test_measure_pino_pde_builders_match_jax(monkeypatch):
    """The first two families of `measure_pino_pde_tpu.main` (the third is
    the first at 65^2 x 256)."""
    script = _jax_script("measure_pino_pde_tpu", monkeypatch)
    twin = _twin("torch_measure_pino_pde")
    pairs = []
    monkeypatch.setattr(script, "run", lambda name, sysd, alg, *a, **kw:
                        pairs.append((sysd, alg)))
    with _jax_config_kept():
        script.main()
    families = twin.families()
    assert [f[3:7] for f in families] == [(800, 25, 289, 10), (400, 25, 729, 6),
                                          (100, 25, 4225, 256)]
    for (jsystem, jalg), family in zip(pairs[:2], families):
        _pino_agree((jsystem, jalg), family[1:3])
    big = families[2][2]
    assert (big.number_of_parameters, big.strategy.dx, big.bounds) == (
        pairs[2][1].number_of_parameters, pairs[2][1].strategy.dx,
        pairs[2][1].bounds)


@pytest.mark.usefixtures("float64_default")
def test_measure_fieldgrid_derivs_builder_matches_jax(monkeypatch):
    """The spectral row at m = 8 (its FD2 twin differs only in
    ``spectral_axes``)."""
    script = _jax_script("measure_fieldgrid_derivs", monkeypatch)
    twin = _twin("torch_measure_fieldgrid_derivs")
    _float64_build(monkeypatch, script)
    jpair = _first_problem(lambda: script.run_row(8, True, 1,
                                                  np.zeros((65, 8))))
    draws = np.random.default_rng(9).normal(size=(9, 16))
    _pino_agree(jpair, twin.build(8, True, 0), draws)
    ic = np.random.default_rng(10).normal(size=(65, 3))
    ic[-1] = ic[0]
    np.testing.assert_allclose(twin.spectral_downsample_1d(ic, 16),
                               script.spectral_downsample_1d(ic, 16),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(twin.exact_heat(ic[:, 0], [0.0, 0.3]),
                               script.exact_heat(ic[:, 0], [0.0, 0.3]),
                               rtol=0, atol=1e-14)


def test_fieldgrid_held_out_ics_equal_the_jax_draw():
    """The 8 held-out heat ICs kept beside the twin are the JAX script's
    draw (`measure_fieldgrid_derivs.py:130-133`): the GRF of length scale
    0.15 on 65 nodes from key 4242, with x64 off as the script ran."""
    kept = np.load(_twin("torch_measure_fieldgrid_derivs").EVAL_ICS)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        grf = jpkg.GaussianRandomField(length_scale=0.15)
        redraw = np.asarray(grf(jax.random.key(4242),
                                [np.linspace(0.0, 1.0, 65)], 8))
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert kept.shape == (65, 8) and kept.dtype == np.float32
    np.testing.assert_array_equal(kept, redraw)


# the keys of the JSON lines the JAX scripts print
JAX_KEYS = {
    "profile_breakdown.py": {"tag", "points_per_sec", "wall_s"},   # :174
    "measure_weak_tpu.py": {"config", "us_per_step"},              # :86
    "measure_weak_accuracy_tpu.py": {                              # :113,185
        "rel_l2", "steps", "wall_s", "final_loss", "problem", "config",
        "seed"},
    "measure_mfu_accuracy.py": {                                   # :185-192
        "width", "batch", "iters", "wall_s", "rel_l2", "step_us",
        "flops_per_step", "tflops", "mfu_pct"},
    "measure_ns_operator_tpu.py": {                                # :135-145
        "row", "backend", "grid", "nu", "derivative", "width", "modes",
        "iters", "wall_s", "final_loss", "per_ic_rel_l2", "mean_rel_l2",
        "eval_protocol", "mean_rel_l2_base_subset"},
    "measure_fieldgrid_derivs.py": {                               # :113-122
        "row", "backend", "grid", "derivative", "iters", "seeds", "wall_s",
        "rel_l2_by_seed", "mean_rel_l2", "eval_protocol"}}


@pytest.mark.parametrize("jax_name, twin", [
    ("profile_breakdown.py", "torch_profile_breakdown"),
    ("measure_weak_tpu.py", "torch_measure_weak"),
    ("measure_weak_accuracy_tpu.py", "torch_measure_weak_accuracy"),
    ("measure_mfu_accuracy.py", "torch_measure_mfu_accuracy"),
    ("measure_ns_operator_tpu.py", "torch_measure_ns_operator"),
    ("measure_fieldgrid_derivs.py", "torch_measure_fieldgrid_derivs")])
def test_twin_lines_hold_the_jax_scripts_keys(jax_name, twin):
    source = ast.parse((ROOT / "scripts" / jax_name).read_text())
    named = ({n.value for n in ast.walk(source)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
             | {k.arg for n in ast.walk(source) if isinstance(n, ast.Call)
                for k in n.keywords})
    assert JAX_KEYS[jax_name] <= named
    keys = set(_twin(twin).KEYS)
    assert JAX_KEYS[jax_name] | {"device", "power_limit"} <= keys


# --------------------------------------------------------------------------
# the breakdown
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name, cls", [
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>",
     "gemm"),
    ("ampere_sgemm_64x64_nn", "gemm"),
    ("void gemmSN_TN_kernel<float, 128, 16, 2, 4, 4, 4, true>", "gemm"),
    ("void splitKreduce_kernel<32, 16, int, float, float>", "gemm"),
    ("void gemvNSP_kernel<float, float, float, float, 1, 8, 4, 1024>",
     "gemm"),
    ("void dot_kernel<float, 128, 0, cublasDotParams<"
     "cublasGemvTensorStridedBatched<float const>>>", "gemm"),
    ("void tanh_jet2_forward_kernel<float>(float const*)", "hand_written"),
    ("void tanh_jet2_backward_kernel<double>(double const*)", "hand_written"),
    ("void zoom_step_kernel<float>(float*)", "hand_written"),
    ("set_conditional(unsigned long long, bool const*)", "hand_written"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "elementwise"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
     "FusedAdam>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     "reduce"),
    ("Memcpy DtoD (Device -> Device)", "copy/layout"),
    ("Memset (Device)", "copy/layout"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>",
     "copy/layout"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     "copy/layout"),
    ("void at::native::index_elementwise_kernel<128, 4>", "copy/layout"),
    ("ncclKernel_AllReduce_RING_LL_Sum_float(ncclDevComm*)", "nccl"),
    ("void at::native::distribution_elementwise_grid_stride_kernel<float, "
     "4, curandStatePhilox4_32_10>", "rng"),
    ("void philox_uniform(unsigned long)", "rng"),
    ("void at::native::some_new_kernel<float>", "other")])
def test_classify_names_a_kernels_class(name, cls):
    twin = _twin("torch_profile_breakdown")
    assert twin.classify(name) == cls
    assert cls in twin.CLASSES


def _event(name, start, end, device=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


class _Trace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_breakdown_of_a_synthetic_trace():
    """Two steps on a 0..1000 us timeline: kernels, a copy, an annotation
    range that must not count, host operations open at the gaps."""
    twin = _twin("torch_profile_breakdown")
    gemm = "ampere_sgemm_64x64_nn"
    events = [
        _event(gemm, 0, 300), _event("tanh_jet2_forward_kernel", 300, 400),
        _event("Memcpy DtoD (Device -> Device)", 450, 500),
        _event(gemm, 600, 800), _event("reduce_kernel", 800, 850),
        _event("Optimizer.step", 0, 900, annotation=True),
        _event("cudaGraphLaunch", 0, 1000, DeviceType.CPU),
        _event("aten::item", 420, 440, DeviceType.CPU),
        _event("cudaStreamSynchronize", 490, 700, DeviceType.CPU)]
    bd = twin.breakdown(_Trace(events), steps=2, step_s=0.5e-3)
    assert bd["categories"] == {
        "gemm": 0.25, "hand_written": 0.05, "elementwise": 0.0,
        "reduce": 0.025, "copy/layout": 0.025, "rng": 0.0, "nccl": 0.0,
        "other": 0.0}
    assert bd["device_busy_ms"] == pytest.approx(0.35)
    assert bd["idle_share"] == pytest.approx(0.3)
    assert bd["kernels"][0] == (gemm, 0.25, 1.0, "gemm")
    assert len(bd["kernels"]) == 4
    # gaps 400-450 (host in cudaGraphLaunch) and 500-600 (in the sync)
    assert bd["gaps"] == [(0.1, "cudaStreamSynchronize"),
                          (0.05, "cudaGraphLaunch")]
    assert twin.classes_sum_to_busy(bd)


def test_the_sum_check_sees_overlapping_kernels():
    twin = _twin("torch_profile_breakdown")
    line = twin.breakdown(_Trace([_event("sgemm", 0, 100),
                                  _event("sgemm", 50, 150)]), 1, 1e-3)
    assert line["device_busy_ms"] == pytest.approx(0.15)
    assert sum(line["categories"].values()) == pytest.approx(0.2)
    assert not twin.classes_sum_to_busy(line)
    near = {"device_busy_ms": 1.0, "categories": {"gemm": 0.995}}
    assert twin.classes_sum_to_busy(near)
    assert not twin.classes_sum_to_busy({**near,
                                         "categories": {"gemm": 0.98}})


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

# the required arguments of the twins' functions that take ``device``
ARGS = {
    "torch_measure_weak.build": (None,),
    "torch_measure_weak_accuracy.build_problem": ("front", None, 0),
    "torch_measure_weak_accuracy.run_fixed": ("front", lambda: None, 1.0,
                                              1e-3, 0),
    "torch_measure_weak_accuracy.run_adaptive": ("front", lambda: None,
                                                 1.0, 1e-3, 0),
    "torch_measure_mfu_accuracy.run_row": (64, 8192, 1.0, 100),
    "torch_probe_allen_cahn_budget.make_problem": (None, 100.0),
    "torch_probe_allen_cahn_budget.run_precision": ("highest", 2),
    "torch_measure_ns_operator.run_row": ("base-fd", 4),
    "torch_measure_fieldgrid_derivs.run_row": (16, False, 4)}


@pytest.mark.parametrize("name", TWINS)
def test_each_twin_defaults_to_the_card_and_raises_without_one(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    twin = _twin(name)
    fns = {f"{name}.{fname}": fn for fname, fn in vars(twin).items()
           if inspect.isfunction(fn) and fn.__module__ == name
           and "device" in inspect.signature(fn).parameters}
    assert f"{name}.run" in fns, sorted(fns)
    for fname, fn in fns.items():
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda", fname
        required = [p for p in params.values()
                    if p.default is inspect.Parameter.empty
                    and p.kind is not inspect.Parameter.VAR_KEYWORD]
        args = ARGS.get(fname, ())
        assert len(args) == len(required), fname
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            fn(*args)

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`neuralpde_tpu_torch`) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It drives the port's main paths: the dense 2-D Poisson trainer of
`bench.py`'s headline (mlp([2, 64, 64, 1]), Taylor-mode derivatives,
stochastic batch of 2,097,152 points in microbatches of 32,768, Adam), the
separable (SPINN) trainer of `bench.py`'s second throughput line and its
accuracy recipes, matrix-free Gauss-Newton, the integro-differential path
(integral terms by batched Gauss-Legendre quadrature, `QuadratureTraining`)
the ODE/DAE solver surface, the trial-function zoo (FBPINN, KAN, DGM,
a wrapped `torch.nn.Module`) with the variational formulations (hp-VPINN
`WeakTraining`, Deep Ritz), the stochastic layer (SDE solvers, HMC/NUTS,
the Bayesian PINNs), the operator layer (DeepONet, FNO, PINOODE,
PINOPDE, ensembles), scale-out and export, the example programs of
`neuralpde_tpu_torch/examples/` and `bench_torch.py`'s rates, in phases
that each print their own lines, their seconds and the memory left
allocated, and raise on failure:

1. device: the card's name, and nvidia-smi's name and power limit;
2. build: the kernel library from `neuralpde_tpu_torch/csrc/` with nvcc;
3. kernel vs plain: each kernel (tanh_jet2 forward, backward, jvp) against
   its plain PyTorch version at the shape each path below gives it, in
   float32 and float64, and both times at the dense path's shape; after
   each later phase every shape a kernel was launched at that was not
   checked yet is held to the plain version the same way (the docs pages
   of phase 35 launch at many small shapes); the L-BFGS line search's
   `zoom_step` against `zoom_transition` on every step of real searches
   and on edge values, bit for bit in float32 and float64, and its time a
   launch beside the plain transition's and an empty kernel's; `sq_sum`
   (the factored mean square's sum of squares) through its wrapper
   against `sq_sum_reference` at the SPINN main path's 16384^2 grid and
   at odd shapes, float32 and float64 (rtol 1e-10), with both times at
   the grid in float32 beside its bytes bound; after each later phase
   every shape `sq_sum` was launched at and not checked yet the same way;
4. card vs CPU: one loss and gradient of the dense bench problem at batch
   32,768, same parameters and points, on the card and the CPU (plain);
5. dense main path: one warm-up step and 20 timed steps through
   `make_step`, then two steps traced by `torch.profiler`, whose device
   time `scripts/torch_profile_breakdown.py` breaks down by kernel class
   (as it does every ``[profile]`` of phases 8, 12 and 33);
6. transforms: `torch.func.jvp` and `torch.func.vjp` in the parameters of
   a Taylor-mode residual, against the nested-jvp engine, on the card;
7. separable card vs CPU: loss and gradient norm of bench's SPINN problem
   on a 128^2 grid;
8. separable main path: bench's `spinn_points_per_sec` configuration
   (16384^2 grid, rank 64) for 20 timed steps, then a profile;
9. separable accuracy: 500 Adam steps on a 128^2 grid, rel L2, for five
   seeds in float32 (median) and the worst of them again in float64;
10. Gauss-Newton: LSQR with float64 scalars on a float32 separable problem,
    rel L2;
11. causal separable: one Allen-Cahn stage of 1000 Adam steps;
12. dense solve: bench's headline through `solve(inner_steps=10)`, which
    replays one captured CUDA graph of the step: 3 steps against 3 eager
    `make_step` steps from the same parameters and generator seed, two
    replays drawing different points, then timed blocks (ms/step, points/s,
    peak GiB, capture time and counts) and a profile of one block;
13. dense causal: stage 1 of bench's dense Allen-Cahn recipe
    (`CausalTraining`, batch 8192, five-layer net of width 64) for 10,000
    steps in blocks of 500 (the recipe's stage runs 333,000);
14. to accuracy: `time_to_l2_hard`, then `time_to_l2_hybrid` (Adam, then
    L-BFGS, whose steps replay a captured graph), each to RMS < 1e-3
    within 120 s;
15. adaptive and sampling: 300 steps of bench's Poisson problem at batch
    8192 with each of the five adaptive losses, with `QuasiRandomTraining`
    (lhs, sobol, lattice) and with `ResidualAdaptiveTraining`; and 20 steps
    of `GridTraining(1/31)` with `GradientScaleAdaptiveLoss` on the card
    against the CPU;
16. checkpoint: 2 x 500 steps with a restart from a checkpoint against
    1000 straight steps;
17. integrals card vs CPU: loss and gradient norm of a Volterra
    integro-differential problem (parametric upper bound) and of a 2-D
    integral constraint (tensor rule), width 64, on the card and the CPU;
18. integro-differential solve: u'' + integral of u from 0 to x = 1 - cos x
    - sin x on [0, pi] (exact sin x), mlp([1, 64, 64, 1]), Taylor-mode
    derivatives, a 20-node rule per point, through `solve`: with
    `StochasticTraining(8192)` (163,840 integrand columns a step), and with
    an auto-refined `QuadratureTraining()` under ``quad_adapt=True``;
19. ODE solver surface: `solve_ode` on a two-component linear system with
    mlp([1, 64, 64, 2]) (default quadrature strategy, grid, forward-mode
    du/dt, parameter estimation from a dataset), `solve_dae`,
    `solve_ode_gauss_newton`, and `neural_adapter` from a trained 2-D
    Poisson net to a smaller one;
20. zoo card vs CPU: loss and gradient norm of a second-order residual
    through `FBPINN` (flat 1-D, multilevel 2-D), `kan([2,8,8,1], degree=5)`,
    `DGM(2,1,24,3)` and `TorchModuleAdapter` on the card and the CPU, and
    each net's Taylor rule against the nested-jvp engine on the card;
21. FBPINN at the width of `examples/fbpinn_multiscale.py`: the 50-period
    two-scale ODE (50 subdomains, 30,000 steps) beside a single MLP, and
    the 2-D multi-scale Laplace problem with a five-level hierarchy of 341
    local nets on 129^2 nodes (as many of its 30,000 steps as 20 s allow),
    with a profile of a short solve;
22. weak forms: the front problem of `scripts/measure_weak_accuracy_tpu.py`
    (96^2 nodes, 10,000 steps each) in strong form, under `WeakTraining`
    at ibp 0, 1, 2 and through `solve_weak_adaptive`; the smooth 2-D
    problem; `solve_gauss_newton` on weak rows (ibp 1, and ibp 0 through
    the `tanh_jet2_jvp` kernel);
23. zoo solvers: `examples/burgers_dgm.py`'s `DeepGalerkin` run (1,500 of
    its 5,000 steps) and the same configuration for all 5,000 on the
    travelling wave, which has an exact solution; a
    hard-constrained KAN on bench's 2-D Poisson; Deep Ritz with Monte-Carlo
    energy;
24. stochastic card vs CPU: `inner_sde_loss` (weak, strong), the BNNODE
    log-density (Lotka-Volterra with data and `estim_collocate`) and the
    BPINN log-density (2-D Poisson, mlp([2,64,64,1]), jet) from the same
    parameters and draws, and a captured HMC chain of 30 draws against the
    same chain run eagerly (bit for bit);
25. SDE: `examples/gbm_sde.py` at its width, the strong-training and
    inverse-EM problems and the OU Fokker-Planck `SDEPINN` of
    tests/test_sde.py, each held to that test's bound;
26. Bayesian: HMC and NUTS on tests/test_bayesian.py's Gaussians, its
    Lotka-Volterra BNNODE at full size (float64, as the test runs it), the
    2-D Poisson BPINN of tests/test_bpinn_pde.py, and the same Poisson as
    `BayesianPINN(mlp([2,64,64,1]), derivative="jet")`, whose draws launch
    `tanh_jet2`, with a profile of its draws;
27. operators card vs CPU: the spectral layers at odd and even sizes on
    random weights (mixed spectra that are not Hermitian), the FNOs, the
    DeepONets, the PINOODE losses, the Navier-Stokes PINOPDE loss (FD,
    spectral x/y, causal) and a jvp and a vjp of its residual vector;
28. PINOODE: the du/dt = cos(p t) family with the w128 DeepONet at 65,536
    points a step, the FNO1D of tests/test_fno.py and its Gauss-Newton
    driver, each held to that test's bound;
29. PINOPDE, the operator layer's main path: the Navier-Stokes vorticity
    operator of the reference's base-fd row (FNO3D w16 m(8,8,4) d3, 33^2 x 9
    grid, 12 GRF ICs, 8,000 steps) scored on the 8 held-out ICs, a traced
    window of replayed steps, the step's device time by operator, the TF32
    question of the complex einsum; the heat family, the resampled IC
    operator, the Gauss-Newton polish and the DeepONetPDE family of
    tests/test_pino_pde.py, each held to that test's bound;
30. ensembles: `solve_pino_pde_ensemble(n_ensemble=8)` on the heat family
    (member 0 against a solo solve from its parameters, ms a step against
    the solo solve) and `solve_ensemble(n_ensemble=8)` on
    scripts/measure_ensemble_tpu.py's 2-D Poisson against a solo solve.
    Phases 27-30 take no Taylor jets and launch no kernel (checked);
31. scale-out: one rank of an NCCL process group per card
    (`initialize_distributed`); bench's dense headline through `solve`
    under `use_mesh(make_mesh())`, its gradient all-reduce captured in the
    step's CUDA graph, against the same solve without a mesh (first step,
    and the loss after 200 steps; ms a step of each), a trace of replays
    for the NCCL kernel, `solve_ensemble(mesh=)` on ensemble-8 and
    `sample_chains(mesh=)` on phase 26's Gaussian against their runs without
    a mesh; with two cards or more, the same solve over min(count, 4)
    cards, one process each, and its speed-up;
32. export: phase 31's trained phi with a dynamic batch through
    `export_phi`, saved and loaded in a fresh process that imports only
    torch, at 2^20 points against phi; the NS operator of phase 29's width
    through `export_pino_pde` against ``sol()``; us a call of each,
    exported against eager;
33. Beltrami (`neuralpde_tpu_torch/examples/beltrami_spinn.py`): card
    against CPU at the tests' size (causal eps 1 and 30), then the
    (3+1)-D Navier-Stokes SPINN on the full 65^4 grid at rank 64 (four
    fields of four axis nets of width 64, 22 conditions), float32 with TF32
    off, 300 steps of the eps = 1 stage through `solve`'s captured graph
    (ms a step, grid points a second, peak GiB, rel L2), and a profile of
    replays (idle share, top device operations);
34. the other example programs the port had never run: card against CPU
    for the Helmholtz, Taylor-Green SPINN, dense Taylor-Green,
    Kuramoto-Sivashinsky and Burgers PINO systems at a small size; then
    `examples/helmholtz3d_spinn.py` at its 2,000 steps (rel L2 bound),
    the Taylor-Green SPINN on 128^3 and the dense Taylor-Green net at
    width 128 for part of their first stage, and Kuramoto-Sivashinsky
    through Adam and L-BFGS (rel L2 bound);
35. the documentation: every page of `docs/torch/` through the shared
    runner (`scripts/torch_docs_runner.py`) under its caps on the card, one
    line a page (seconds, the last printed lines, tanh_jet2 launches with
    the replays of captured graphs); a page that raises or prints a NaN or
    an inf fails the phase, and so does memory left allocated beyond
    phase 34's level;
36. L-BFGS (`npde.lbfgs()`, optax.lbfgs()'s rule): the w64 Poisson
    `GridTraining(1/127)` jet problem for 10 float64 steps on the card
    (eagerly, and captured with the line-search trials as IF nodes) and on
    the CPU from the same parameters (parameters within a stated
    tolerance, line-search counts equal), then the hybrid recipe's L-BFGS
    ms a step in turns: captured, the same steps eagerly, and
    `torch.optim.LBFGS` passed as a factory (evaluations a step, IF
    bodies entered and skipped, capture seconds, peak memory).
37. bench: `bench_torch.py`'s default line without its accuracy suite
    (whose functions phases 9 to 11 run), at bench's sizes with 3 timed
    steps a rate: the dense w64, w128 and w256 steps and the SPINN step
    through `solve`'s captured graph, the TF32 pair, the FLOP counts, the
    CPU baseline and the float32 and TF32 matmul ceilings; every key, finite
    positive numbers, each mfu_pct in (0, 100];
38. the measurement scripts (`scripts/torch_*.py`, the twins of the JAX
    package's TPU scripts), each main function at a smoke budget: the
    op-level breakdown of the dense step (524,288 points) at 2 steps,
    weak against strong form at 384^2 nodes at 3 steps, the weak-form
    accuracy script's strong and hp-adaptive rows of the front problem
    at a 0.3-s budget, an ensemble of 2, the MFU script's w64 row at a
    5-s budget, trust region and LSQR at 2 outer iterations, one
    Allen-Cahn stage at 50 iterations, the NS operator's base row, the
    PINOPDE families and the field-grid derivatives at 16 nodes at 4
    steps each; every JSON line parses, has its script's keys and finite
    numbers; the breakdown's classes sum to its busy time within 1%, with
    non-zero GEMM and hand-written kernel time.

Phases 9, 11 to 19, 21 to 23, 28 to 31 and 33 to 38 train through
`solve`, which on the card runs each kind of step once as it is, then
captures it as a CUDA graph and replays it: a wrapper's counter sees the
eager step and the capture, and each replay reports the launches of its
capture to `kernels.tanh_jet.add_replayed` (the graphs of `solve`, of the
HMC draws and of Gauss-Newton's inner iterations). The JSON line of
kernels sums, over the counted phases, the wrappers' launches (the eager
paths of phases 5, 6, 8 and 20, phases 18 and 21 to 23, phase 26's jet
sampler, phase 31's solve under the mesh, the example programs' solves in
phases 33 and 34, the pages of phase 35, phase 36's L-BFGS runs,
phase 37's bench rates and phase 38's scripts, each counted from 0 just
before its solve, sampler or page and read just after, with the forward
and backward kernels required wherever the path takes second derivatives
by Taylor mode) and the launches of every replay in those phases; a
`[launches]` line gives the two parts per phase.  `zoom_step` is counted
from 0 at each phase's start and read at its end; a replay of a captured
L-BFGS step launches it once a trial body that ran, which the solve
reports from the device's count when it ends.  Every kernel of the line
must have launched.  `sq_sum` is counted through its wrapper only (the
eager steps and the captures), zeroed before each counted phase: no
replay reports it.  Every other graph phase,
like phase 10 (Gauss-Newton's LSQR graph), prints its own counts apart;
phases 27 to 30 and 32 print theirs, which must be 0. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``. Without a CUDA device it exits
non-zero and prints no result.

Cuts against the recipes, each named where its phase prints: phase 11 runs
1000 of the separable stage's 15,000 steps, phase 13 10,000 of the dense
stage's 333,000, phase 21's Laplace problem the steps that 20 s allow of
30,000, phase 23's Burgers example 1,500 of 5,000; phase 27's Navier-Stokes
check trains no step and takes 2 of the 12 family members; phase 32's NS
operator trains 25 of 8,000 steps (its export is measured, not its
training), phase 31's multi-card run (two cards or more) 60 steps, phase
33's Beltrami SPINN 300 of its recipe's 3 x 20,000, and phase 34's
Taylor-Green runs 1,000 (separable) and 2,000 (dense) of 2 x 20,000.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HIDDEN = 64
LAPLACE_LEVELS = (1, 2, 4, 8, 16)   # examples/fbpinn_multiscale.py, L = 4
ZOO_LEVELS = (1, 2, 4)              # the multilevel FBPINN of phase 20
BATCH = 2_097_152          # bench.py's BATCH
MICROBATCH = 32_768        # bench.py's MICROBATCH
STEPS = 20
CHECK_BATCH = 32_768
CHECK_MICROBATCH = 8_192
KERNEL_SHAPE = (HIDDEN, MICROBATCH)   # the dense path's; timed
CHECK_SHAPES = (KERNEL_SHAPE,
                (HIDDEN, 16_384),    # separable main path (phase 8)
                (24, 33),            # Gauss-Newton (phase 10)
                # a separable net's two end points of an axis (phases 7-11)
                (HIDDEN, 2), (24, 2),
                (HIDDEN, 256),       # Allen-Cahn stage (phase 11)
                (HIDDEN, 8_192),     # dense causal (13), to accuracy (14),
                                     # the integro-differential solve (18)
                (HIDDEN, 1_024),     # their boundary batches; the 32^2
                                     # grid of phase 26's jet BPINN
                # the nodes of an auto-refined QuadratureTraining() rule in
                # phase 18: 8 per panel, panels doubling up to its budget
                *((HIDDEN, 8 * 2 ** k) for k in range(7)),
                # the trial-function zoo and the weak forms (phases 20-23):
                # every level of the Laplace FBPINN, (J, hidden, nodes)
                *((j * j, 16, 129 * 129) for j in LAPLACE_LEVELS),
                # FBPINN card-vs-CPU: flat on 32 nodes, three levels on 32^2
                (4, 16, 32), *((j * j, 16, 1_024) for j in ZOO_LEVELS),
                (24, 512), (24, 1_024),   # DGM: Burgers batch, card-vs-CPU
                # KAN (tanh of its input, then of each hidden layer): the
                # Poisson batch, card-vs-CPU
                (2, 8_192), (8, 8_192), (2, 1_024), (8, 1_024),
                (HIDDEN, 9_216),     # the weak grid, 96^2 nodes
                (16, 66),            # Gauss-Newton on ibp=0 rows: 6 x 11 nodes
                # the example programs (phases 33-34): Beltrami's x, y, z
                # axes on 65 nodes, Helmholtz and Taylor-Green SPINN on 128,
                # the dense Taylor-Green net at width 128, KS on 51 x 11
                (HIDDEN, 65), (HIDDEN, 128), (128, 8_192), (32, 561),
                # their card-vs-CPU checks: hidden 8 on 2 (the probe) to 6
                # nodes an axis, the dense Taylor-Green net on 64 points
                (8, 2), (8, 4), (8, 5), (8, 6), (8, 64))
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}
CARD_VS_CPU_RTOL = {"loss": 1e-5, "grad_norm": 1e-4}
# sq_sum against its plain version: both sum in float64, in other orders
SQ_SUM_RTOL = 1e-10
TRANSFORM_RTOL = 1e-4
SPINN_N = 16_384            # bench.py spinn_points_per_sec
SPINN_RANK = 64
SPINN_STEPS = 20
SPINN_CHECK_N = 128         # accuracy_suite's 128^2 grid
# sq_sum's checks (phase 3): the SPINN main path's grid (timed), the
# accuracy grid and odd shapes (a tail past the 16-byte loads)
SQ_SUM_SHAPES = ((SPINN_N, SPINN_N), (SPINN_CHECK_N, SPINN_CHECK_N),
                 (1023, 1029), (3, 5))
SPINN_SEEDS = (0, 1, 2, 3, 4)
# rel L2 over these seeds on an H100: float32 median 1.54e-3, worst 3.96e-3
# (seed 0), which moves to 5e-2 under other last-bit roundings of Adam
# (optax's order too), so the worst seed is held in float64 (1.59e-3):
# "median" limits the float32 seeds, "max" the worst seed's float64 run.
# JAX's record 1.44e-3
SPINN_REL_L2_LIMIT = {"median": 2e-3, "max": 5e-3}
GN_MAXITERS = 200           # accuracy_suite's Gauss-Newton budget
GN_CG_ITERS = 200
DENSE_BLOCK = 10            # inner_steps of the dense solve (phase 12)
DENSE_BLOCKS = 12           # timed: blocks 2..12 (block 1 holds the capture)
EAGER_VS_GRAPH_RTOL = 1e-6
CAUSAL_STEPS = 10_000       # of the dense recipe's 333,000 in stage 1
CAUSAL_BLOCK = 500
TO_L2_CAP_S = 120.0
ADAPTIVE_STEPS = 300
ADAPTIVE_BATCH = 8_192
ADAPTIVE_CARD_VS_CPU_RTOL = 1e-4
CHECKPOINT_RTOL = 1e-6
# summed in the kernels line
COUNTED_PHASES = (5, 6, 8, 18, 20, 21, 22, 23, 26, 31, 33, 34, 35, 36, 37,
                  38)
# memory the docs pages (phase 35) may leave allocated beyond phase 34's:
# the quadrature rules kept on the device per dtype (`rule_tensors`)
DOCS_MEMORY_SLACK = 64 * 2**20
INTEGRAL_ORDER = 20         # nodes of each point's integral (phase 18)
IDE_BATCH = 8_192
IDE_STEPS = 3_000
IDE_BLOCK = 100
# rel L2 against sin x after IDE_STEPS of Adam(2e-3): 1.9e-3 (stochastic, at
# batch 512) and 1.1e-3 (quadrature) in float32 on the CPU
IDE_REL_L2_LIMIT = 1e-2
# the JAX package's own tests' bounds (tests/test_nnode.py:54,
# tests/test_nnode.py:110, tests/test_solvers_extra.py:35)
ODE_L2_LIMIT = 0.1
ODE_PARAM_RTOL = 0.05
# tests/test_solvers_extra.py:109 holds a 1-D target of amplitude 1 to 0.05
# in the maximum norm; the 2-D target here is held to 0.05 in relative L2
# (its maximum-norm error falls under 0.14 only after these 10,000 steps)
ADAPTER_LIMIT = 0.05
# float32 with forward-mode du/dt; the JAX package's test holds its float64
# run to 1e-4 (tests/test_gauss_newton.py:353)
ODE_GN_L2_LIMIT = 1e-3
JAX_RECORD = {"poisson_spinn_rel_l2": 1.44e-3, "gn_rel_l2": 2.80e-5,
              "allen_cahn_rel_l2": 0.0457}   # BENCH_r05.json, TPU v5e
ZOO_GRID = 1.0 / 31             # 32 nodes an axis in phase 20
FBPINN_STEPS = 30_000           # examples/fbpinn_multiscale.py's budget
FBPINN_BLOCK = 500
FBPINN_ODE_LIMIT = 0.05
# the example's rel L2 in the JAX package on a TPU (docs/src/examples/
# fbpinn_multiscale.md): FBPINN, single MLP
FBPINN_ODE_JAX = (0.0015, 0.71)
LAPLACE_CAP_S = 20.0
LAPLACE_BLOCK = 50
WEAK_STEPS = 10_000
WEAK_BLOCK = 100
WEAK_ROUNDS = (3_400, 3_300, 3_300)
# the JAX package's own tests' bounds: tests/test_weak.py:190 (rel L2 of the
# smooth 2-D problem) and :313,315 (Gauss-Newton on weak rows: rel L2,
# objective), tests/test_coverage2.py:162 (DGM travelling wave, maximum
# error), tests/test_kan.py:84, tests/test_ritz.py:69
WEAK_SMOOTH_LIMIT = 0.2
WEAK_GN_LIMITS = (1e-3, 1e-4)
DGM_LIMIT = 0.02
DGM_STEPS = 5_000               # examples/burgers_dgm.py's budget
DGM_EXAMPLE_STEPS = 1_500       # of it on the example's own problem, which
                                # has no exact solution to be held to
KAN_LIMIT = 0.05
RITZ_LIMIT = 5e-2
# the JAX package's own tests' bounds: tests/test_sde.py:42,79,104 (GBM mean,
# inverse EM drift, OU density), tests/test_bayesian.py:156 (Lotka-Volterra
# parameters), tests/test_bpinn_pde.py:123 (2-D Poisson RMS)
SDE_GBM_LIMIT = 0.15
SDE_INVERSE_LIMIT = 0.15
SDE_OU_LIMIT = 0.35
BNNODE_PARAM_RTOL = 0.05
BPINN_RMS_LIMIT = 0.05
BPINN_JET_DRAWS = 300          # the kernel path of phase 26
BPINN_JET_LEAPFROG = 20


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{name}; {torch.cuda.device_count()} device(s)")
    print(smi)
    return name, smi


def phase_build() -> None:
    from neuralpde_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    diagnostics = _build.build_library(force=True)
    seconds = time.perf_counter() - t0
    _build.load_library()
    sources = [p.name for p in sorted(_build.CSRC_DIR.glob("*.cu"))]
    print(f"[build] {_build.LIBRARY.name} from {sources} for sm_90a in "
          f"{seconds:.2f} s")
    for line in diagnostics.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def _event_ms(fn, iters: int = 50) -> float:
    """Time of one call of ``fn`` between CUDA events over ``iters`` calls
    after a warm-up call: device time plus any gap the host's launch
    overhead leaves between calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof) -> list:
    """The device's own events of a profiler trace (kernels, copies,
    fills), without the ranges that annotate them (a captured step's
    ``Optimizer.step`` range would count its kernels twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _kernel_us(prof) -> float:
    """Sum of the device kernels' own times in a profiler trace, in us."""
    return sum(e.self_device_time_total for e in _device_events(prof))


def _device_ms(fn, iters: int = 50) -> float:
    """Device time of one call of ``fn``: its kernels' own times from
    `torch.profiler` over ``iters`` calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _kernel_us(prof) / 1e3 / iters


def _in_turns(timer, plain, kernel) -> tuple[float, float]:
    """Time plain, kernel, kernel, plain; the mean of each pair."""
    p1, k1, k2, p2 = (timer(f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _check_kernels(shape, dtype, g, results: dict, card: str,
                   tag: str = "") -> None:
    """Each kernel against its plain version at ``shape`` and ``dtype``
    (`TOL`); the largest error goes into ``results``; at the dense path's
    shape both are timed in turns."""
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    z, z1, z2, ga, ga1, ga2 = (
        2 * torch.randn(shape, generator=g, dtype=dtype, device="cuda")
        for _ in range(6))
    cases = {
        "tanh_jet2_forward": (
            lambda: tj.tanh_jet2_forward_cuda(z, z1, z2),
            lambda: tj.tanh_jet2_reference(z, z1, z2)),
        "tanh_jet2_backward": (
            lambda: tj.tanh_jet2_backward_cuda(z, z1, z2, ga, ga1, ga2),
            lambda: tj.tanh_jet2_backward_reference(z, z1, z2, ga, ga1,
                                                    ga2)),
        "tanh_jet2_jvp": (
            lambda: tj.tanh_jet2_jvp_cuda(z, z1, z2, ga, ga1, ga2),
            lambda: tj.tanh_jet2_jvp_reference(z, z1, z2, ga, ga1, ga2)),
    }
    for name, (kernel, plain) in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL[dtype])
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        r = results.setdefault(name, dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        line = (f"[kernel]{tag} {name} {str(dtype)[6:]} {shape}: "
                f"max_abs_err {err:.3e} (tolerance {TOL[dtype]})")
        if shape == KERNEL_SHAPE and not tag:
            ms, plain_ms = _in_turns(_device_ms, plain, kernel)
            call_ms, plain_call_ms = _in_turns(_event_ms, plain, kernel)
            line += (f"; device time kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms; per call with launch "
                     f"kernel {call_ms:.4f} ms, plain "
                     f"{plain_call_ms:.4f} ms; {card}")
            if dtype == torch.float32:
                r.update(ms=ms, plain_ms=plain_ms)
        print(line)


def phase_kernels(card: str) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.float64):
        for shape in CHECK_SHAPES:
            _check_kernels(shape, dtype, g, results, card)
    return [dict(name=name, route="cuda",
                 source="neuralpde_tpu_torch/csrc/tanh_jet.cu",
                 replaces="neuralpde_tpu/ops/derivatives.py:84",
                 **_bound(name, KERNEL_SHAPE, torch.float32),
                 library_ms=None, **r)
            for name, r in results.items()] + [_check_zoom(card),
                                               _sq_sum_kernel(card)]


def _check_sq_sum(shape, dtype, g, results: dict, card: str,
                  tag: str = "") -> None:
    """`sq_sum` through its wrapper (the kernel, on a CUDA tensor) against
    `sq_sum_reference` at ``shape`` and ``dtype`` (`SQ_SUM_RTOL`); the
    largest error goes into ``results``; at the SPINN main path's grid in
    float32 both are timed in turns, beside the bytes bound."""
    from neuralpde_tpu_torch.kernels import sq_sum as sq

    r = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
    got = sq.sq_sum(r)
    torch.cuda.synchronize()
    want = sq.sq_sum_reference(r)
    torch.testing.assert_close(got, want, rtol=SQ_SUM_RTOL, atol=0)
    err = float((got - want).abs())
    results["max_abs_err"] = max(results.get("max_abs_err", 0.0), err)
    line = (f"[kernel]{tag} sq_sum {str(dtype)[6:]} {shape}: max_abs_err "
            f"{err:.3e}, relative {err / float(want):.3e} (rtol "
            f"{SQ_SUM_RTOL:g})")
    if shape == SQ_SUM_SHAPES[0] and dtype == torch.float32 and not tag:
        kernel, plain = (functools.partial(f, r) for f in (
            sq.sq_sum, sq.sq_sum_reference))
        ms, plain_ms = _in_turns(_device_ms, plain, kernel)
        call_ms, plain_call_ms = _in_turns(_event_ms, plain, kernel)
        bound = _sq_sum_bound(shape, dtype)
        line += (f"; device time kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                 f"ms; per call with launch kernel {call_ms:.4f} ms, plain "
                 f"{plain_call_ms:.4f} ms; bound by {bound['bound_by']} "
                 f"{bound['bound_ms']:.4f} ms, "
                 f"{100 * bound['bound_ms'] / ms:.1f}% of it; {card}")
        results.update(ms=ms, plain_ms=plain_ms, **bound)
    print(line)


def _sq_sum_kernel(card: str) -> dict:
    """`_check_sq_sum` at each of `SQ_SUM_SHAPES`, float32 and float64: the
    kernel's entry of the kernels line."""
    g = torch.Generator(device="cuda").manual_seed(0)
    results: dict = {}
    for dtype in (torch.float32, torch.float64):
        for shape in SQ_SUM_SHAPES:
            _check_sq_sum(shape, dtype, g, results, card)
    return dict(name="sq_sum", route="cuda",
                source="neuralpde_tpu_torch/csrc/sq_sum.cu",
                replaces="neuralpde_tpu/strategies.py:28", library_ms=None,
                **results)


def _sq_sum_bound(shape, dtype) -> dict:
    """The least time of one `sq_sum`: the tensor read once at the memory
    rate, or its square and add a value at the float32 rate."""
    numel = math.prod(shape)
    by_bytes = numel * dtype.itemsize / H100_BYTES_PER_S
    by_ops = 2 * numel / H100_F32_FLOPS
    return {"bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _launch_floor_ms() -> float:
    """Device time of an empty kernel launched through the kernels'
    library: the least any launch takes."""
    import ctypes

    from neuralpde_tpu_torch.kernels import _build

    lib = _build.load_library()
    lib.neuralpde_empty_launch.argtypes = [ctypes.c_void_p]
    return _device_ms(lambda: _build.check(
        lib, lib.neuralpde_empty_launch(
            torch.cuda.current_stream().cuda_stream), "empty launch"),
        iters=ZOOM_TIMED)


def _check_zoom(card: str) -> dict:
    """`zoom_step` against `zoom_transition` on every step of real searches
    and on edge values (`transition_cases`), float32 and float64, bit for
    bit (tolerance 0); then, in float32, the kernel's device time a launch
    against the plain transition's host time on CPU tensors (the path it
    replaces reads the value and slope on the host and steps there)."""
    from neuralpde_tpu_torch.kernels import lbfgs_zoom as lz

    err = 0.0
    for dtype, tdt in ((np.float32, torch.float32),
                       (np.float64, torch.float64)):
        cases = lz.transition_cases(dtype, searches=ZOOM_SEARCHES)
        n = len(cases)
        state = torch.tensor(np.stack([c[0] for c in cases]), device="cuda")
        value, slope = (torch.tensor(np.array([c[i] for c in cases],
                                              dtype=dtype), device="cuda")
                        for i in (1, 2))
        flag = torch.zeros(n, dtype=torch.bool, device="cuda")
        info = [torch.full((n,), -1, dtype=d, device="cuda")
                for d in (tdt, torch.int64, tdt, tdt)]
        for i in range(n):
            lz.zoom_step_cuda(state[i], value[i], slope[i], flag[i],
                              *(t[i] for t in info))
        torch.cuda.synchronize()
        got, flags = state.cpu().numpy(), flag.cpu().numpy()
        steps = info[1].cpu().numpy()
        rates = [t.cpu().numpy() for t in (info[0], info[2], info[3])]
        bad = 0
        for i, case in enumerate(cases):
            want, _, searching = lz.zoom_transition(*case)
            same = got[i].tobytes() == want.tobytes() and flags[i] == searching
            if same and not searching:
                same = (steps[i] == int(want[lz.COUNT]) and all(
                    r[i].tobytes() == want[f].tobytes() for r, f in zip(
                        rates, (lz.STEPSIZE, lz.DEC_ERR, lz.CURV_ERR))))
            if not same:
                bad += 1
                diff = np.abs(got[i].astype(np.float64) - want)
                err = max(err, float(np.nanmax(np.where(
                    np.isnan(diff), np.inf, diff))))
        print(f"[kernel] zoom_step {np.dtype(dtype).name}: {n} transitions "
              f"({ZOOM_SEARCHES} searches and their edge values) "
              f"{n - bad} bit-equal to zoom_transition (tolerance: bit for "
              f"bit)")
        if bad:
            raise AssertionError(f"zoom_step {np.dtype(dtype).name}: {bad} "
                                 f"transitions differ from the plain version")
    cases = lz.transition_cases(np.float32, searches=6)
    s0, v0, d0 = cases[len(cases) // 2]
    dev = [torch.tensor(x, device="cuda") for x in (s0, v0, d0)]
    host = [torch.tensor(x) for x in (s0, v0, d0)]

    def scratch(device):
        return [torch.zeros((), dtype=torch.bool, device=device)] + [
            torch.zeros((), dtype=d, device=device)
            for d in (torch.float32, torch.int64, torch.float32,
                      torch.float32)]

    dev_out, host_out = scratch("cuda"), scratch("cpu")

    def kernel():
        lz.zoom_step_cuda(*dev, *dev_out)

    def plain():
        lz.zoom_step_reference(*host, *host_out)

    ms = _device_ms(kernel, iters=ZOOM_TIMED)
    call_ms = _event_ms(kernel, iters=ZOOM_TIMED)
    plain()
    t0 = time.perf_counter()
    for _ in range(ZOOM_TIMED):
        plain()
    plain_ms = 1e3 * (time.perf_counter() - t0) / ZOOM_TIMED
    floor = _launch_floor_ms()
    bound = _zoom_bound()
    print(f"[kernel] zoom_step float32: device time {ms:.5f} ms a launch, "
          f"{call_ms:.5f} ms a call with its launch; the plain transition "
          f"{plain_ms:.5f} ms a call on the host; an empty kernel "
          f"{floor:.5f} ms (the floor of a launch-bound kernel); bound by "
          f"{bound['bound_by']} {bound['bound_ms']:.3e} ms; {card}")
    return dict(name="zoom_step", route="cuda",
                source="neuralpde_tpu_torch/csrc/lbfgs_zoom.cu",
                replaces="neuralpde_tpu/train.py:95", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=None, **bound)


def _zoom_bound() -> dict:
    """The least time of one `zoom_step` in float32 on the card: its state,
    value and slope read once, state, flag and info written once, at the
    memory rate, or its operations at the float32 rate, whichever is
    longer (both far below a launch)."""
    from neuralpde_tpu_torch.kernels import lbfgs_zoom as lz

    by_bytes = ((lz.STATE_SIZE + 2) * 4 + lz.STATE_SIZE * 4 + 1 + 3 * 4 + 8
                ) / H100_BYTES_PER_S
    by_ops = ZOOM_OPS / H100_F32_FLOPS
    return {"bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def check_launched_shapes(number: int, checked: set, sq_checked: set,
                          kernels: list[dict], card: str) -> None:
    """Hold every kernel to its plain version at each shape launched in
    phase ``number`` that no phase checked yet (float32 and float64), as
    phase 3 does, and fold the errors into ``kernels``: the tanh_jet2
    kernels' shapes in ``checked``, `sq_sum`'s in ``sq_checked``."""
    from neuralpde_tpu_torch.kernels import sq_sum as sq
    from neuralpde_tpu_torch.kernels.tanh_jet import LAUNCH_SHAPES

    new = sorted({shape for _, shape in LAUNCH_SHAPES} - checked)
    sq_new = sorted({shape for _, shape in sq.LAUNCH_SHAPES} - sq_checked)
    if not new and not sq_new:
        return
    g = torch.Generator(device="cuda").manual_seed(number)
    results: dict = {}
    tag = f"[phase {number}]"
    for shape in new:
        for dtype in (torch.float32, torch.float64):
            _check_kernels(shape, dtype, g, results, card, tag=tag)
        checked.add(shape)
    for shape in sq_new:
        for dtype in (torch.float32, torch.float64):
            _check_sq_sum(shape, dtype, g,
                          results.setdefault("sq_sum", {}), card, tag=tag)
        sq_checked.add(shape)
    for k in kernels:
        if k["name"] in results:
            k["max_abs_err"] = max(k["max_abs_err"],
                                   results[k["name"]]["max_abs_err"])
    print(f"[kernel] phase {number}: {len(new) + len(sq_new)} new launched "
          f"shape(s) held to the plain versions: {new + sq_new}")


# Tensors each kernel reads and writes, and float operations per element
# counted from its plain version's arithmetic (tanh counted as one).
KERNEL_IO = {"tanh_jet2_forward": (3, 3, 10), "tanh_jet2_backward": (6, 3, 30),
             "tanh_jet2_jvp": (6, 3, 30)}
H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA's data sheet (SXM, 700 W)
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores, the same
ZOOM_SEARCHES = 100             # searches of phase 3's zoom_step check
ZOOM_TIMED = 200                # timed launches of zoom_step
# float operations of one zoom transition at most (the errors, the phase's
# updates, a cubic and a quadratic step), counted from the plain version
ZOOM_OPS = 80


def _bound(name: str, shape, dtype) -> dict:
    """The least time the card could take for one call at ``shape``: each
    input read once and each output written once at the memory rate, or
    the operations at the float32 rate, whichever is longer."""
    n_in, n_out, ops = KERNEL_IO[name]
    numel = math.prod(shape)
    by_bytes = (n_in + n_out) * numel * dtype.itemsize / H100_BYTES_PER_S
    by_ops = ops * numel / H100_F32_FLOPS
    return {"bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _loss_and_grad_norm(prob) -> tuple[float, float]:
    from neuralpde_tpu_torch import matmul_precision

    pinnrep = prob.pinnrep
    theta = {k: v.clone().requires_grad_(True)
             for k, v in prob.init_params.items()}
    lf = pinnrep.loss_functions
    ada = pinnrep.adaloss.init_state(len(lf.pde_loss_functions),
                                     len(lf.bc_loss_functions), pinnrep.dtype,
                                     pinnrep.device)
    with matmul_precision(pinnrep.matmul_precision):
        loss, _ = prob.loss(theta, {"generator": None, "adaptive": ada})
        loss.backward()
    norm = math.sqrt(sum(float((v.grad.double() ** 2).sum())
                         for v in theta.values() if v.grad is not None))
    return float(loss.detach()), norm


def _card_vs_cpu_problem(what: str, build, tag: str) -> None:
    """Loss and gradient norm of ``build(device, init_params)`` on the CPU
    and on the card, from the CPU problem's initial parameters."""
    results, init = {}, None
    for device in ("cpu", "cuda"):
        prob = build(device, init)
        init = {k[len("depvar."):]: v.cpu()
                for k, v in prob.init_params.items()}
        results[device] = _loss_and_grad_norm(prob)
        torch.cuda.synchronize()
    _card_vs_cpu_line(what, results["cpu"], results["cuda"], tag=tag)


def _cpu_points_sampler(points: torch.Generator):
    """A sampler drawing uniform points from ``points`` on the CPU, so that
    the card and the CPU train on the same points."""
    from neuralpde_tpu_torch.ops.sampling import uniform_random

    def sampler(n, lb, ub, generator):
        return uniform_random(n, lb.cpu(), ub.cpu(), points).to(lb.device)

    return sampler


def phase_card_vs_cpu() -> None:
    points = torch.Generator()

    def build(device, init):
        from bench_torch import poisson_problem

        points.manual_seed(1)
        prob = poisson_problem(CHECK_BATCH, microbatch=CHECK_MICROBATCH,
                               device=device, init_params=init,
                               matmul_precision="highest")
        prob.pinnrep.strategy.sampler = _cpu_points_sampler(points)
        return prob

    _card_vs_cpu_problem(f"batch {CHECK_BATCH} microbatch {CHECK_MICROBATCH}"
                         " f32 highest", build, "card-vs-cpu")


def phase_main_path(card: str) -> dict:
    from bench_torch import poisson_problem
    from neuralpde_tpu_torch import adam, make_step
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    prob = poisson_problem(BATCH, microbatch=MICROBATCH)
    pinnrep = prob.pinnrep
    lf = pinnrep.loss_functions
    step = make_step(prob.loss, adam(1e-3), pinnrep.adaloss,
                     lf.pde_loss_functions, lf.bc_loss_functions,
                     matmul_precision=pinnrep.matmul_precision)
    ada = pinnrep.adaloss.init_state(1, 4, pinnrep.dtype, pinnrep.device)
    carry = step.init(prob.init_params, ada)
    generator = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    tj.reset_launch_counts()
    carry, (loss, _) = step(carry, generator)          # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        carry, (loss, _) = step(carry, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = tj.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    values = [float(v) for v in losses]
    points = BATCH + 4 * (BATCH // 8)
    pps = points * STEPS / dt
    print(f"[main] batch {BATCH} microbatch {MICROBATCH} mlp([2,{HIDDEN},"
          f"{HIDDEN},1]) jet Adam(1e-3) f32: {STEPS} steps in {dt:.3f} s, "
          f"{1e3 * dt / STEPS:.1f} ms/step, {pps:.6g} points/s, peak "
          f"{peak_gib:.2f} GiB; {card}")
    print(f"[main] losses {values[0]:.6g} -> {values[-1]:.6g}; "
          f"launches {counts}")
    _require_falling("main path", values)
    _require_launched("main path", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward")
    _profile(functools.partial(_steps, step, carry, generator, 2), 2,
             dt / STEPS)
    return counts


def _require_falling(what: str, values) -> None:
    if not all(map(math.isfinite, values)):
        raise AssertionError(f"{what}: non-finite loss in {values}")
    if not np.mean(values[-5:]) < values[0]:
        raise AssertionError(f"{what}: loss did not fall: {values}")


def _require_launched(what: str, counts: dict, *names) -> None:
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{what} never launched {name}")


def _steps(step, carry, generator, n: int) -> None:
    for _ in range(n):
        carry, _ = step(carry, generator)


def _profile(run, n: int, step_s: float) -> dict:
    """Trace ``run()``, ``n`` steps, and print the breakdown of its device
    time by kernel class (`scripts/torch_profile_breakdown.py`), the idle
    share against the traced window, beside the untraced step time
    ``step_s``."""
    from torch.profiler import ProfilerActivity, profile

    twin = _script("torch_profile_breakdown")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / n
    bd = twin.breakdown(prof, n, traced)
    print(f"[profile] {n} steps traced, {traced * 1e3:.3f} ms a step traced "
          f"against {step_s * 1e3:.3f} ms untraced:")
    twin.report(bd, "[profile] ")
    return bd


def _rel(got: dict, want: dict) -> float:
    """max |got - want| / max |want| over all entries of two dicts."""
    num = max(float((got[k] - want[k]).abs().max()) for k in want)
    return num / max(float(w.abs().max()) for w in want.values())


def phase_transforms(card: str) -> dict:
    """`torch.func.jvp` and `vjp` in the parameters of a Taylor-mode
    residual (tanh_jet2 forward, jvp and backward kernels) against the
    nested-jvp engine (plain ops), on the card."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.nn.core import TrialFunction
    from torch.func import jvp, vjp

    g = torch.Generator().manual_seed(2)
    net = npde.mlp([2, HIDDEN, HIDDEN, 1], dtype=torch.float32)
    net.reset_parameters(g)
    theta = {k: v.detach().cuda() for k, v in net.named_parameters()}
    tangent = {k: torch.randn(v.shape, generator=g).cuda()
               for k, v in theta.items()}
    x = torch.rand((2, MICROBATCH), generator=g).cuda()
    cot = torch.randn((1, MICROBATCH), generator=g).cuda()

    def residual(engine):
        return lambda th: engine(TrialFunction(net, th), x, [0, 0], 2)

    jet, nested = (residual(npde.DerivativeEngine(m)) for m in ("jet", "jvp"))
    with npde.matmul_precision("highest"):
        tj.reset_launch_counts()
        t0 = time.perf_counter()
        jv = jvp(jet, (theta,), (tangent,))[1]
        uj = vjp(jet, theta)[1](cot)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tj.launch_counts()
        jv_ref = jvp(nested, (theta,), (tangent,))[1]
        uj_ref = vjp(nested, theta)[1](cot)[0]
    err_jvp = _rel({"r": jv}, {"r": jv_ref})
    err_vjp = _rel(uj, uj_ref)
    print(f"[transforms] mlp([2,{HIDDEN},{HIDDEN},1]) Dxx by jet, "
          f"{MICROBATCH} points, f32 highest: jvp rel {err_jvp:.3e}, vjp rel "
          f"{err_vjp:.3e} against the nested-jvp engine (limit "
          f"{TRANSFORM_RTOL}); {seconds:.3f} s; launches {counts}; {card}")
    if not (err_jvp <= TRANSFORM_RTOL and err_vjp <= TRANSFORM_RTOL):
        raise AssertionError("transforms: the jet route disagrees")
    _require_launched("transforms", counts, "tanh_jet2_forward",
                      "tanh_jet2_jvp", "tanh_jet2_backward")
    return counts


def phase_separable_card_vs_cpu() -> None:
    from neuralpde_tpu_torch.accuracy import poisson_spinn

    _card_vs_cpu_problem(
        f"{SPINN_CHECK_N}^2 grid rank {SPINN_RANK} f32 highest",
        lambda device, init: poisson_spinn(
            SPINN_CHECK_N, HIDDEN, SPINN_RANK, device=device,
            init_params=init, matmul_precision="highest")[0],
        "separable-card-vs-cpu")


def phase_separable_main(card: str) -> dict:
    """bench.py's spinn_points_per_sec: 20 timed Adam steps on the 16384^2
    grid after one warm-up step, then two profiled steps."""
    from neuralpde_tpu_torch import adam, make_step
    from neuralpde_tpu_torch.accuracy import poisson_spinn
    from neuralpde_tpu_torch.kernels import sq_sum as sq
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    prob, _ = poisson_spinn(SPINN_N, HIDDEN, SPINN_RANK)
    pinnrep = prob.pinnrep
    if pinnrep.strategy.routes != ["factored"]:
        raise AssertionError(f"separable main path: routes "
                             f"{pinnrep.strategy.routes}, not the factored "
                             f"one")
    step = make_step(prob.loss, adam(2e-3), pinnrep.adaloss,
                     matmul_precision=pinnrep.matmul_precision)
    carry = step.init(prob.init_params, pinnrep.adaloss.init_state(
        1, 0, pinnrep.dtype, pinnrep.device))
    generator = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tj.reset_launch_counts()
    sq.sq_sum_cuda.launches = 0
    carry, (loss, _) = step(carry, generator)          # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SPINN_STEPS):
        carry, (loss, _) = step(carry, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {**tj.launch_counts(), "sq_sum": sq.sq_sum_cuda.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    values = [float(v) for v in losses]
    pps = SPINN_N * SPINN_N * SPINN_STEPS / dt
    print(f"[spinn] {SPINN_N}^2 grid rank {SPINN_RANK} mlp([1,{HIDDEN},"
          f"{HIDDEN},{SPINN_RANK}]) hard Adam(2e-3) f32: {SPINN_STEPS} steps "
          f"in {dt:.3f} s, {1e3 * dt / SPINN_STEPS:.2f} ms/step, {pps:.6g} "
          f"points/s, peak {peak_gib:.2f} GiB; {card}")
    print(f"[spinn] losses {values[0]:.6g} -> {values[-1]:.6g}; "
          f"launches {counts}")
    _require_falling("separable main path", values)
    _require_launched("separable main path", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward", "sq_sum")
    _profile(functools.partial(_steps, step, carry, generator, 2), 2,
             dt / SPINN_STEPS)
    return counts


def phase_separable_accuracy(card: str) -> dict:
    """accuracy_suite item 1: 500 Adam steps on the 128^2 grid, for each of
    `SPINN_SEEDS` (the initial parameters) in float32, and for the worst of
    them in float64: float32 rounding alone moves a seed's rel L2 by 10x,
    so the median holds the float32 seeds and the float64 run the worst."""
    from neuralpde_tpu_torch.accuracy import poisson_spinn_rel_l2
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    tj.reset_launch_counts()
    runs = {seed: poisson_spinn_rel_l2(seed=seed) for seed in SPINN_SEEDS}
    counts = tj.launch_counts()
    for seed, r in runs.items():
        print(f"[spinn-accuracy] seed {seed}: {SPINN_CHECK_N}^2 grid, 500 "
              f"Adam(2e-3) steps in blocks of 100: {r['seconds']:.2f} s, "
              f"losses {r['history']}, rel L2 {r['rel_l2']:.4e}; {card}")
    rels = [r["rel_l2"] for r in runs.values()]
    worst = max(runs, key=lambda seed: runs[seed]["rel_l2"])
    witness = poisson_spinn_rel_l2(seed=worst, dtype=torch.float64)
    got = {"median": float(np.median(rels)), "max": witness["rel_l2"]}
    print(f"[spinn-accuracy] rel L2 over seeds {list(runs)}: float32 median "
          f"{got['median']:.4e}, float32 max {max(rels):.4e} (seed {worst}); "
          f"seed {worst} in float64 {got['max']:.4e} ({witness['seconds']:.2f}"
          f" s); limits {SPINN_REL_L2_LIMIT} on the float32 median and the "
          f"float64 run; JAX reference on TPU v5e: "
          f"{JAX_RECORD['poisson_spinn_rel_l2']}; float32 launches {counts}")
    if not (all(map(math.isfinite, rels)) and all(
            got[k] < limit for k, limit in SPINN_REL_L2_LIMIT.items())):
        raise AssertionError(f"separable accuracy: rel L2 {rels}, seed "
                             f"{worst} in float64 {got['max']}, beyond "
                             f"{SPINN_REL_L2_LIMIT}")
    return counts


def phase_gauss_newton(card: str) -> None:
    """accuracy_suite item 2 (`accuracy.gauss_newton_rel_l2`): LM with
    LSQR, float64 scalars, on a float32 separable problem.  Each outer
    iteration runs two LSQR steps as they are, captures one as a CUDA graph
    and replays it for the rest; a counter sees the captured launches once,
    not their replays, so this phase's counts stay out of the kernels
    line."""
    from neuralpde_tpu_torch.accuracy import gauss_newton_rel_l2
    from neuralpde_tpu_torch.gauss_newton import _EAGER_STEPS
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    tj.reset_launch_counts()
    r = gauss_newton_rel_l2(maxiters=GN_MAXITERS, cg_iters=GN_CG_ITERS)
    counts = tj.launch_counts()
    rel, seconds, iters, hist = (r["rel_l2"], r["seconds"], r["iterations"],
                                 r["history"])
    print(f"[gauss-newton] mlp([1,24,24,24]) per axis, 33^2 grid, f32 "
          f"problem, LSQR {GN_CG_ITERS} iterations with f64 scalars: "
          f"{iters} outer iterations in {seconds:.2f} s "
          f"({seconds / max(iters, 1):.3f} s each); objective "
          f"{hist[0]:.4e} -> {hist[-1]:.4e}; rel L2 {rel:.4e} (JAX reference "
          f"on TPU v5e at 200 iterations: {JAX_RECORD['gn_rel_l2']}); "
          f"launches counted, eager and at capture: {counts}, besides "
          f"{iters} x {GN_CG_ITERS - _EAGER_STEPS} uncounted graph "
          f"replays of one LSQR step; {card}")
    if not rel < 1e-3:
        raise AssertionError(f"gauss-newton: rel L2 {rel} >= 1e-3")
    _require_launched("gauss-newton", counts, "tanh_jet2_jvp",
                      "tanh_jet2_backward")


def phase_causal(card: str) -> dict:
    """bench.py's Allen-Cahn stage 1: 1000 Adam steps with causal weights."""
    from neuralpde_tpu_torch import adam, solve
    from neuralpde_tpu_torch.accuracy import allen_cahn_net, allen_cahn_stage
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    prob, strategy = allen_cahn_stage(allen_cahn_net(256), 100.0)
    ada = prob.pinnrep.adaloss.init_state(1, 1, torch.float32, "cuda")
    with torch.no_grad():
        loss0 = float(prob.loss(prob.init_params,
                                {"generator": None, "adaptive": ada})[0])
        w0 = strategy.causal_weights(prob.init_params)[0]
    tj.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(prob, adam(1e-3), maxiters=1000, inner_steps=1000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = tj.launch_counts()
    with torch.no_grad():
        w = strategy.causal_weights(res.u)[0].double().cpu().numpy()
    print(f"[causal] Allen-Cahn stage 1, 256^2 grid, rank 256, causal_eps "
          f"100, Adam(1e-3) 1000 steps: {seconds:.2f} s; loss {loss0:.5g} -> "
          f"{res.objective:.5g}; last causal weight {float(w0[-1]):.3g} -> "
          f"{w[-1]:.3g}; launches {counts}; {card}")
    if not (math.isfinite(res.objective) and res.objective < loss0):
        raise AssertionError(f"causal: loss {loss0} -> {res.objective}")
    if not (w[0] == 1.0 and np.all(np.diff(w) <= 0)):
        raise AssertionError(f"causal: weights not non-increasing in t: {w}")
    return counts


def _graph_line(res) -> str:
    g = res.aux["cuda_graph"]
    return (f"{g['captures']} capture(s) in {g['capture_seconds']:.3f} s, "
            f"{g['replays']} replays")


def phase_dense_solve(card: str) -> None:
    """bench's dense headline through `solve`: the captured step against
    eager steps, fresh points per replay, then timed blocks and a profile
    of one block."""
    from bench_torch import poisson_problem
    from neuralpde_tpu_torch import adam, make_step, solve
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.ops.sampling import uniform_random
    from neuralpde_tpu_torch.train import GraphedSteps, _side_stream

    drawn = torch.zeros((2, 8), device="cuda")

    def sampler(n, lb, ub, generator):
        """uniform_random, keeping the first PDE points of the last draw
        (a copy inside the step, so a replay updates it)."""
        pts = uniform_random(n, lb, ub, generator)
        if n == BATCH:
            drawn.copy_(pts[:, :8])
        return pts

    prob = poisson_problem(BATCH, microbatch=MICROBATCH)
    prob.pinnrep.strategy.sampler = sampler
    pinnrep = prob.pinnrep
    lf = pinnrep.loss_functions

    # the same 3 steps, eager and through the graph
    step = make_step(prob.loss, adam(1e-3), pinnrep.adaloss,
                     lf.pde_loss_functions, lf.bc_loss_functions,
                     matmul_precision=pinnrep.matmul_precision)
    carry = step.init(prob.init_params,
                      pinnrep.adaloss.init_state(1, 4, pinnrep.dtype, "cuda"))
    generator = torch.Generator(device="cuda").manual_seed(7)
    eager = []
    for _ in range(3):
        carry, (loss, _) = step(carry, generator)
        eager.append(float(loss))
    graphed = solve(prob, adam(1e-3), maxiters=3, inner_steps=3,
                    generator=torch.Generator(device="cuda").manual_seed(7))
    d_loss = abs(graphed.objective - eager[-1]) / abs(eager[-1])
    d_params = _rel(graphed.u, {k: v.detach() for k, v in carry[0].items()})
    print(f"[dense-solve] 3 steps, eager make_step vs solve(inner_steps=3) "
          f"(1 eager step, capture, 2 replays), same parameters and "
          f"generator seed: losses {eager} vs {graphed.objective:.9g}; rel "
          f"difference loss {d_loss:.3e}, parameters {d_params:.3e} (limit "
          f"{EAGER_VS_GRAPH_RTOL})" + (
              "" if d_loss == d_params == 0 else
              "; not 0: the graph's reductions and GEMMs may take another "
              "algorithm or order than the eager calls on the default "
              "stream"))
    if not (d_loss <= EAGER_VS_GRAPH_RTOL and d_params <= EAGER_VS_GRAPH_RTOL):
        raise AssertionError("dense solve: the graph disagrees with eager "
                             "steps")

    # two replays draw different points
    step = make_step(prob.loss, adam(1e-3), pinnrep.adaloss,
                     lf.pde_loss_functions, lf.bc_loss_functions,
                     matmul_precision=pinnrep.matmul_precision)
    carry = step.init(prob.init_params,
                      pinnrep.adaloss.init_state(1, 4, pinnrep.dtype, "cuda"))
    runner = GraphedSteps(step, carry,
                          torch.Generator(device="cuda").manual_seed(0))
    seen = []
    with _side_stream(drawn):
        for i in range(3):
            runner(i)
            seen.append(drawn.clone())
    torch.cuda.synchronize()
    fresh = not torch.equal(seen[1], seen[2])
    print(f"[dense-solve] first PDE point of replay 1 {seen[1][:, 0].tolist()}"
          f", of replay 2 {seen[2][:, 0].tolist()}: fresh points per replay "
          f"{fresh}")
    if not fresh:
        raise AssertionError("dense solve: a replay drew the same points")

    # timed blocks through solve
    stamps = []

    def stamp(it, loss, aux):
        stamps.append((it, time.perf_counter(), loss))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tj.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(prob, adam(1e-3), maxiters=DENSE_BLOCK * DENSE_BLOCKS,
                inner_steps=DENSE_BLOCK, callback=stamp)
    counts = tj.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    first_block = stamps[0][1] - t0
    steps = stamps[-1][0] - stamps[0][0]
    dt = stamps[-1][1] - stamps[0][1]
    points = BATCH + 4 * (BATCH // 8)
    print(f"[dense-solve] batch {BATCH} microbatch {MICROBATCH} mlp([2,"
          f"{HIDDEN},{HIDDEN},1]) jet Adam(1e-3) f32, solve(inner_steps="
          f"{DENSE_BLOCK}): first block (1 eager step, capture, "
          f"{DENSE_BLOCK - 2} replays) {first_block:.3f} s; then {steps} "
          f"replayed steps in {dt:.3f} s: {1e3 * dt / steps:.2f} ms/step, "
          f"{points * steps / dt:.6g} points/s; peak {peak_gib:.2f} GiB; "
          f"{_graph_line(res)}; launches counted (eager step and capture) "
          f"{counts}; {card}")
    print(f"[dense-solve] losses per block {[round(x[2], 6) for x in stamps]}")
    _require_falling("dense solve", [x[2] for x in stamps])
    _require_launched("dense solve", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward")
    _profile_block(runner, 3, DENSE_BLOCK, dt / steps)


def _profile_block(runner, start: int, n: int, step_s: float) -> None:
    """`_profile` of ``n`` replays of a warmed `GraphedSteps`."""
    from neuralpde_tpu_torch.train import _side_stream

    def replays():
        with _side_stream(next(iter(runner.theta.values()))):
            for i in range(start, start + n):
                runner(i)

    _profile(replays, n, step_s)


def _profile_solve(prob, optimizer, steps: int, block: int,
                   step_s: float) -> None:
    """Trace a short `solve` (one eager step, a capture, ``steps - 2``
    replays): the device's busy time per step against the untraced step
    time ``step_s`` of a long solve, and the kernels with the most time."""
    from neuralpde_tpu_torch import solve
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(prob, optimizer, maxiters=steps, inner_steps=block)
        torch.cuda.synchronize()
    busy_us = _kernel_us(prof)
    kernels = sorted(_device_events(prof),
                     key=lambda e: -e.self_device_time_total)
    print(f"[profile] a solve of {steps} steps (1 eager, {steps - 1} "
          f"replayed): device busy {busy_us / steps / 1e3:.3f} ms per step "
          f"against {step_s * 1e3:.3f} ms untraced: idle share "
          f"{1 - busy_us / steps / 1e6 / step_s:.3f}; {len(kernels)} "
          f"distinct kernels, {sum(e.count for e in kernels) // steps} "
          f"launches a step")
    for e in kernels[:8]:
        print(f"[profile] {100 * e.self_device_time_total / busy_us:5.1f}% "
              f"{e.self_device_time_total / steps / 1e3:8.4f} ms/step "
              f"{e.count // steps:6d} calls/step  {e.key[:90]}")


def phase_dense_causal(card: str) -> None:
    """Stage 1 of bench's dense Allen-Cahn recipe, cut to CAUSAL_STEPS."""
    from neuralpde_tpu_torch import adam, solve
    from neuralpde_tpu_torch.accuracy import (
        DENSE_AC_ITERS, DENSE_AC_STAGES, dense_allen_cahn_problem,
    )
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    eps, lr = DENSE_AC_STAGES[0]
    prob, strategy = dense_allen_cahn_problem(eps)
    tj.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(prob, adam(lr), maxiters=CAUSAL_STEPS,
                inner_steps=CAUSAL_BLOCK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = tj.launch_counts()
    with torch.no_grad():
        w = strategy.causal_weights(res.u)[0].double().cpu().numpy()
    hist = res.history
    print(f"[dense-causal] Allen-Cahn, CausalTraining(8192, t, bcs_points="
          f"1024, n_slabs=32, causal_eps={eps}), Chain(PeriodicEmbedding, "
          f"mlp([21,64,64,64,64,1])), jet, Adam({lr}), {res.iterations} steps "
          f"in blocks of {CAUSAL_BLOCK} (cut from the recipe's "
          f"{DENSE_AC_ITERS[0]}): {seconds:.2f} s, "
          f"{res.iterations / seconds:.1f} steps/s; loss {hist[0]:.5g} -> "
          f"{hist[-1]:.5g}; last slab weight {w[-1]:.4g}; "
          f"{_graph_line(res)}; launches counted {counts}; {card}")
    _require_falling("dense causal", hist)
    if not (np.all(np.isfinite(w)) and np.all(np.diff(w) <= 0)):
        raise AssertionError(f"dense causal: weights not finite and "
                             f"non-increasing: {w}")
    _require_launched("dense causal", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward")


def phase_to_accuracy(card: str) -> None:
    """bench's --to-l2-hard and --to-l2-hybrid recipes, capped."""
    from neuralpde_tpu_torch.accuracy import time_to_l2_hard, time_to_l2_hybrid
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    for name, fn in (("hard", time_to_l2_hard), ("hybrid", time_to_l2_hybrid)):
        tj.reset_launch_counts()
        r = fn(max_seconds=TO_L2_CAP_S)
        counts = tj.launch_counts()
        extra = (f"; Adam stage {r['adam_seconds']:.2f} s; npde.lbfgs() "
                 f"steps replayed from a captured graph (a capture a "
                 f"500-step solve): {r['lbfgs_ms_per_step']:.2f} ms/step"
                 if name == "hybrid" else "")
        print(f"[to-accuracy] {name}: RMS {r['rms']:.3e} after "
              f"{r['iterations']} iterations, "
              f"{'%.2f s' % r['seconds'] if r['seconds'] else 'not reached'} "
              f"to RMS < 1e-3 (cap {TO_L2_CAP_S} s){extra}; trace "
              f"{[(i, round(e, 6), round(t, 2)) for i, e, t in r['trace']]}; "
              f"launches counted {counts}; {card}")
        if r["seconds"] is None:
            raise AssertionError(f"to accuracy ({name}): RMS {r['rms']} "
                                 f"not below 1e-3 within {TO_L2_CAP_S} s")


def _poisson(strategy, device, *, adaloss=None, dtype=torch.float32,
             init_params=None):
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_2d_system

    return npde.discretize(poisson_2d_system(), npde.PhysicsInformedNN(
        npde.mlp([2, HIDDEN, HIDDEN, 1], dtype=dtype), strategy,
        derivative="jet", dtype=dtype, device=device, adaptive_loss=adaloss,
        init_params=init_params))


def phase_adaptive_sampling(card: str) -> None:
    """The five adaptive losses and the three quasi-random designs and RAD
    through `solve` on the card; one reweighting run card against CPU."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    n, n_bc = ADAPTIVE_BATCH, ADAPTIVE_BATCH // 8
    runs = {name: (npde.StochasticTraining(n, bcs_points=n_bc),
                   getattr(npde, name)(reweight_every=10))
            for name in ("GradientScaleAdaptiveLoss", "MiniMaxAdaptiveLoss",
                         "SoftAdaptAdaptiveLoss", "ReLoBRaLoAdaptiveLoss",
                         "InverseDirichletAdaptiveLoss")}
    runs.update({f"QuasiRandomTraining({alg})": (
        npde.QuasiRandomTraining(n, bcs_points=n_bc, sampling_alg=alg), None)
        for alg in ("lhs", "sobol", "lattice")})
    runs["ResidualAdaptiveTraining"] = (
        npde.ResidualAdaptiveTraining(n, bcs_points=n_bc), None)
    for name, (strategy, adaloss) in runs.items():
        plain = []     # the unweighted loss, which reweighting leaves alone

        def record(it, loss, aux):
            plain.append(float(aux["pde_losses"].sum()
                               + aux["bc_losses"].sum()))

        prob = _poisson(strategy, "cuda", adaloss=adaloss)
        tj.reset_launch_counts()
        t0 = time.perf_counter()
        res = npde.solve(prob, npde.adam(1e-3), maxiters=ADAPTIVE_STEPS,
                         inner_steps=10, callback=record)
        seconds = time.perf_counter() - t0
        counts = tj.launch_counts()
        ada = res.aux["adaptive_state"]
        weights = torch.cat([ada["pde_weights"], ada["bc_weights"]])
        print(f"[adaptive-sampling] {name}: {ADAPTIVE_STEPS} steps in "
              f"{seconds:.2f} s; weighted loss {res.history[0]:.5g} -> "
              f"{res.history[-1]:.5g}, unweighted {plain[0]:.5g} -> "
              f"{plain[-1]:.5g}; weights "
              f"{[round(float(w), 5) for w in weights]}; {_graph_line(res)}; "
              f"launches counted (eager steps and captures) {counts}; {card}")
        _require_launched(name, counts, "tanh_jet2_forward",
                          "tanh_jet2_backward")
        _require_falling(name, plain)
        if not all(map(math.isfinite, res.history)):
            raise AssertionError(f"{name}: non-finite loss {res.history}")
        if not bool(torch.isfinite(weights).all()):
            raise AssertionError(f"{name}: non-finite weights {weights}")

    losses, init = {}, None
    for device in ("cpu", "cuda"):
        prob = _poisson(npde.GridTraining(1 / 31), device,
                        adaloss=npde.GradientScaleAdaptiveLoss(
                            reweight_every=5),
                        dtype=torch.float64, init_params=init)
        init = {k[len("depvar."):]: v.cpu()
                for k, v in prob.init_params.items()}
        res = npde.solve(prob, npde.adam(1e-3), maxiters=20)
        losses[device] = (np.asarray(res.history),
                          res.aux["adaptive_state"]["bc_weights"].cpu())
    rel = float(np.max(np.abs(losses["cuda"][0] - losses["cpu"][0])
                       / np.abs(losses["cpu"][0])))
    print(f"[adaptive-sampling] GridTraining(1/31) with "
          f"GradientScaleAdaptiveLoss(reweight_every=5), 20 steps, f64: "
          f"card vs CPU losses rel {rel:.3e} (limit "
          f"{ADAPTIVE_CARD_VS_CPU_RTOL}); bc weights card "
          f"{losses['cuda'][1].tolist()} vs CPU {losses['cpu'][1].tolist()}")
    if not rel <= ADAPTIVE_CARD_VS_CPU_RTOL:
        raise AssertionError("adaptive: the card disagrees with the CPU")


def phase_checkpoint(card: str) -> None:
    """2 x 500 steps with a restart from a checkpoint against 1000 straight
    steps, on the card."""
    import tempfile

    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    def run(what, maxiters, checkpoint_dir=None):
        prob = _poisson(npde.StochasticTraining(
            ADAPTIVE_BATCH, bcs_points=ADAPTIVE_BATCH // 8), "cuda")
        tj.reset_launch_counts()
        res = npde.solve(prob, npde.adam(1e-3), maxiters=maxiters,
                         inner_steps=100, checkpoint_dir=checkpoint_dir)
        counts = tj.launch_counts()
        print(f"[checkpoint] {what}: {res.iterations} iterations, "
              f"{_graph_line(res)}; launches counted (eager step and "
              f"capture) {counts}")
        _require_launched(f"checkpoint ({what})", counts,
                          "tanh_jet2_forward", "tanh_jet2_backward")
        return res

    straight = run("straight", 1000)
    with tempfile.TemporaryDirectory() as d:
        first = run("first 500", 500, d)
        resumed = run("resumed", 1000, d)
    d_loss = abs(resumed.objective - straight.objective) / abs(
        straight.objective)
    d_params = _rel(resumed.u, straight.u)
    print(f"[checkpoint] 1000 straight steps: loss {straight.objective:.9g}; "
          f"500 ({first.objective:.9g}), checkpoint, restart, 500 more: loss "
          f"{resumed.objective:.9g}; rel difference loss {d_loss:.3e}, "
          f"parameters {d_params:.3e} (limit {CHECKPOINT_RTOL}); {card}")
    if not (resumed.iterations == 1000 and d_loss <= CHECKPOINT_RTOL
            and d_params <= CHECKPOINT_RTOL):
        raise AssertionError("checkpoint: the resumed run differs")


def _volterra(device, init_params=None):
    """i'(t) + 2 i(t) + 5 ∫₀ᵗ i(s) ds = 1, i(0) = 0, on [0, 2]: a 1-D
    integral whose upper bound is the collocation point."""
    import neuralpde_tpu_torch as npde

    t = npde.symbols("t")
    i = npde.DepVar("i")
    eq = npde.Eq(npde.Differential(t)(i(t)) + 2.0 * i(t)
                 + 5.0 * npde.Integral(t, 0.0, t)(i(t)), 1.0)
    system = npde.PDESystem(eq, [npde.Eq(i(0.0), 0.0)],
                            [npde.Domain(t, npde.Interval(0, 2))], [t], [i(t)])
    return npde.discretize(system, npde.PhysicsInformedNN(
        npde.mlp([1, HIDDEN, HIDDEN, 1]), npde.GridTraining(0.01),
        integral_order=INTEGRAL_ORDER, dtype=torch.float32, device=device,
        init_params=init_params, matmul_precision="highest"))


def _integral_constraint(device, init_params=None):
    """∫∫ u dx dy over the unit square = 1/3 with u(0, 0) = 1, u_x = -2x,
    u_y = -2y: a 2-D tensor rule."""
    import neuralpde_tpu_torch as npde

    x, y = npde.symbols("x y")
    u = npde.DepVar("u")
    eq = npde.Eq(npde.Integral((x, y), (0.0, 0.0), (1.0, 1.0))(u(x, y)),
                 1.0 / 3.0)
    bcs = [npde.Eq(u(0.0, 0.0), 1.0),
           npde.Eq(npde.Differential(x)(u(x, y)), -2.0 * x),
           npde.Eq(npde.Differential(y)(u(x, y)), -2.0 * y)]
    system = npde.PDESystem(eq, bcs, [npde.Domain(x, npde.Interval(0, 1)),
                                      npde.Domain(y, npde.Interval(0, 1))],
                            [x, y], [u(x, y)])
    return npde.discretize(system, npde.PhysicsInformedNN(
        npde.mlp([2, HIDDEN, HIDDEN, 1]), npde.GridTraining(0.05),
        integral_order=INTEGRAL_ORDER, dtype=torch.float32, device=device,
        init_params=init_params, matmul_precision="highest"))


def phase_integrals_card_vs_cpu() -> None:
    for name, build in (("Volterra, 201 points x 20 nodes", _volterra),
                        ("2-D constraint, 441 points x 400 nodes",
                         _integral_constraint)):
        results, init = {}, None
        for device in ("cpu", "cuda"):
            prob = build(device, init)
            init = {k[len("depvar."):]: v.cpu()
                    for k, v in prob.init_params.items()}
            results[device] = _loss_and_grad_norm(prob)
            torch.cuda.synchronize()
        (cpu_loss, cpu_norm), (gpu_loss, gpu_norm) = (results["cpu"],
                                                      results["cuda"])
        d_loss = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
        d_norm = abs(gpu_norm - cpu_norm) / abs(cpu_norm)
        print(f"[integrals-card-vs-cpu] {name}, width {HIDDEN}, f32 highest: "
              f"loss {gpu_loss:.9g} vs {cpu_loss:.9g} (rel {d_loss:.2e}), "
              f"grad norm {gpu_norm:.9g} vs {cpu_norm:.9g} (rel "
              f"{d_norm:.2e}); limits {CARD_VS_CPU_RTOL}")
        if not all(map(math.isfinite, (gpu_loss, gpu_norm, cpu_loss,
                                       cpu_norm))):
            raise AssertionError("integrals card-vs-cpu: non-finite values")
        if (d_loss > CARD_VS_CPU_RTOL["loss"]
                or d_norm > CARD_VS_CPU_RTOL["grad_norm"]):
            raise AssertionError("integrals card-vs-cpu: the card disagrees")


def integro_differential_problem(strategy, device="cuda"):
    """u''(x) + ∫₀ˣ u(s) ds = 1 − cos x − sin x on [0, π], u(0) = 0,
    u'(0) = 1; the solution is sin x."""
    import neuralpde_tpu_torch as npde

    x = npde.symbols("x")
    u = npde.DepVar("u")
    eq = npde.Eq((npde.Differential(x) ** 2)(u(x))
                 + npde.Integral(x, 0.0, x)(u(x)),
                 1.0 - npde.cos(x) - npde.sin(x))
    bcs = [npde.Eq(u(0.0), 0.0), npde.Eq(npde.Differential(x)(u(0.0)), 1.0)]
    system = npde.PDESystem(eq, bcs, [npde.Domain(x, npde.Interval(0, np.pi))],
                            [x], [u(x)])
    return npde.discretize(system, npde.PhysicsInformedNN(
        npde.mlp([1, HIDDEN, HIDDEN, 1]), strategy, derivative="jet",
        integral_order=INTEGRAL_ORDER, dtype=torch.float32, device=device))


def phase_integro_differential(card: str) -> dict:
    """The integro-differential problem through `solve`: one eager step, a
    capture, replays.  Every point's integral is a 20-node rule, so the
    stochastic run evaluates the network at 8192 x 20 columns a step beside
    the 8192 second derivatives by Taylor mode (the tanh_jet2 kernels).
    Returns the launches counted over both solves (each solve's eager step
    and capture; the replays launch the captured kernels uncounted)."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.ops.quadrature import _RULE_TENSORS

    xs = np.linspace(0, np.pi, 201)
    total: dict = {}
    for name, strategy in (
            (f"StochasticTraining({IDE_BATCH})",
             npde.StochasticTraining(IDE_BATCH)),
            ("QuadratureTraining() auto-refined, quad_adapt=True",
             npde.QuadratureTraining())):
        quadrature = isinstance(strategy, npde.QuadratureTraining)
        prob = integro_differential_problem(strategy)
        stamps = []

        def stamp(it, loss, aux):
            torch.cuda.synchronize()
            stamps.append((it, time.perf_counter(), loss))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tj.reset_launch_counts()
        t0 = time.perf_counter()
        res = npde.solve(prob, npde.adam(2e-3), maxiters=IDE_STEPS,
                         inner_steps=IDE_BLOCK, callback=stamp,
                         quad_adapt=quadrature)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tj.launch_counts()
        _add(total, counts)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        pred = prob.pinnrep.phi(xs[None, :], npde.depvar_params(res.u))[0]
        rel = float(np.linalg.norm(pred.cpu().numpy() - np.sin(xs))
                    / np.linalg.norm(np.sin(xs)))
        steps = stamps[-1][0] - stamps[0][0]
        dt = stamps[-1][1] - stamps[0][1]
        if quadrature:
            reports = strategy.validate_trained(res.u, warn=False)
            nodes = 8 * reports[0]["panels"]
            work = (f"{nodes} nodes ({reports[0]['panels']} panels of 8, "
                    f"check on the trained solution ok={reports[0]['ok']}) x "
                    f"{INTEGRAL_ORDER} integrand columns each")
        else:
            work = (f"{IDE_BATCH} points x {INTEGRAL_ORDER} = "
                    f"{IDE_BATCH * INTEGRAL_ORDER} integrand columns a step, "
                    f"{IDE_BATCH * steps / dt:.6g} points/s")
        print(f"[integro-differential] {name}, mlp([1,{HIDDEN},{HIDDEN},1]) "
              f"jet, integral_order {INTEGRAL_ORDER}, Adam(2e-3) f32: {work}; "
              f"{res.iterations} steps in {seconds:.2f} s (first block of "
              f"{IDE_BLOCK}, with the eager step and the capture, "
              f"{stamps[0][1] - t0:.3f} s; then {1e3 * dt / steps:.3f} "
              f"ms/step); loss {res.history[0]:.5g} -> {res.history[-1]:.5g}; "
              f"rel L2 against sin x {rel:.4e} (limit {IDE_REL_L2_LIMIT}); "
              f"peak {peak_gib:.3f} GiB; {_graph_line(res)}; launches "
              f"counted (eager step and capture) {counts}; {card}")
        _require_falling(f"integro-differential ({name})", res.history)
        _require_launched(f"integro-differential ({name})", counts,
                          "tanh_jet2_forward", "tanh_jet2_backward")
        if res.aux["cuda_graph"]["replays"] < res.iterations - 2:
            raise AssertionError(f"integro-differential ({name}): steps ran "
                                 "outside the captured graph")
        if not rel < IDE_REL_L2_LIMIT:
            raise AssertionError(f"integro-differential ({name}): rel L2 "
                                 f"{rel} >= {IDE_REL_L2_LIMIT}")
        if not quadrature:
            _profile_solve(prob, npde.adam(2e-3), 2 * IDE_BLOCK, IDE_BLOCK,
                           dt / steps)
    on_card = [k for k in _RULE_TENSORS if k[4].type == "cuda"]
    print(f"[integro-differential] rule tensors kept on the card: "
          f"{[(k[0], k[1], k[2], str(k[3])[6:]) for k in on_card]}")
    if not on_card:
        raise AssertionError("integro-differential: no rule tensor on the card")
    return total


def _oscillator(f, **kw):
    """u1' = p0 u2, u2' = -u1 on [0, pi], u(0) = (1, 0): for p0 = 1 the
    solution is (cos t, -sin t)."""
    from neuralpde_tpu_torch import ODEProblem

    return ODEProblem(f, np.array([1.0, 0.0]), (0.0, np.pi),
                      analytic=lambda u0, p, t: np.array([np.cos(t),
                                                          -np.sin(t)]), **kw)


def _require_graph(what: str, res, eager: int = 2) -> str:
    g = res.aux["cuda_graph"]
    if g["replays"] < res.iterations - eager * g["captures"] or not g["captures"]:
        raise AssertionError(f"{what}: steps ran outside captured graphs: {g}")
    return _graph_line(res)


def phase_ode_surface(card: str) -> None:
    """`solve_ode`, `solve_dae`, `solve_ode_gauss_newton` and
    `neural_adapter`, on their default device (the card), each held to the
    bound of the JAX package's own test."""
    import neuralpde_tpu_torch as npde
    from torch.func import functional_call

    def f(u, p, t):
        return [p[0] * u[1], -u[0]]

    def net():
        return npde.mlp([1, HIDDEN, HIDDEN, 2])

    one = np.array([1.0])
    # NNODE's quadrature loss integrates the fourth power of the residual
    # (as the JAX package's), whose gradient fades as the residual falls:
    # the default strategy gets four times the steps at twice the rate
    runs = {
        "default strategy (QuadratureTraining), Adam(1e-2)": (npde.NNODE(
            net(), npde.adam(1e-2)), dict(maxiters=10_000)),
        "GridTraining(pi/40), Adam(5e-3)": (npde.NNODE(
            net(), npde.adam(5e-3)), dict(dt=np.pi / 40, maxiters=2500)),
        "GridTraining(pi/40), autodiff, Adam(5e-3)": (npde.NNODE(
            net(), npde.adam(5e-3), autodiff=True),
            dict(dt=np.pi / 40, maxiters=2500)),
    }
    for name, (alg, kw) in runs.items():
        t0 = time.perf_counter()
        sol = npde.solve_ode(_oscillator(f, p=one), alg, abstol=1e-10,
                             inner_steps=100, **kw)
        seconds = time.perf_counter() - t0
        res = sol.original
        graph = _require_graph(name, res)
        print(f"[ode] solve_ode, u1' = u2, u2' = -u1 on [0, pi], mlp([1,"
              f"{HIDDEN},{HIDDEN},2]) f32, {name}: "
              f"{res.iterations} steps in {seconds:.2f} s; loss "
              f"{res.history[0]:.4g} -> {res.objective:.4g}; errors "
              f"{sol.errors} (limit l2 < {ODE_L2_LIMIT}); {graph}; {card}")
        if not sol.errors["l2"] < ODE_L2_LIMIT:
            raise AssertionError(f"ode ({name}): l2 {sol.errors['l2']}")

    # parameter estimation: recover p0 = 1 from 0.5 with data of the solution
    ts = np.linspace(0.0, np.pi, 40)
    dataset = [np.cos(ts), -np.sin(ts), ts, np.full_like(ts, ts[1] - ts[0])]
    t0 = time.perf_counter()
    sol = npde.solve_ode(
        _oscillator(f, p=np.array([0.5])),
        npde.NNODE(net(), npde.adam(5e-3), param_estim=True, dataset=dataset,
                   estim_collocate=True),
        dt=np.pi / 40, maxiters=4000, abstol=1e-10, inner_steps=100)
    seconds = time.perf_counter() - t0
    p_hat = float(sol.original.u["p"][0])
    graph = _require_graph("param_estim", sol.original)
    print(f"[ode] solve_ode with param_estim, dataset of 40 points and the "
          f"Data Quadrature loss, Adam(5e-3): {sol.original.iterations} steps "
          f"in {seconds:.2f} s; p0 0.5 -> {p_hat:.5f} (true 1, limit "
          f"{ODE_PARAM_RTOL} relative); {graph}; {card}")
    if not abs(p_hat - 1.0) < ODE_PARAM_RTOL:
        raise AssertionError(f"ode (param_estim): p0 {p_hat}")

    # DAE: u1' = u1 (differential), 0 = u1 + u2 (algebraic)
    dae = npde.DAEProblem(
        f=lambda du, u, p, t: [du[0] - u[0], u[0] + u[1]],
        u0=np.array([1.0, -1.0]), du0=np.array([1.0, -1.0]), tspan=(0.0, 1.0),
        differential_vars=[True, False],
        analytic=lambda u0, p, t: np.array([np.exp(t), -np.exp(t)]))
    t0 = time.perf_counter()
    sol = npde.solve_dae(dae, npde.NNDAE(net(), npde.adam(5e-3)), dt=0.05,
                         maxiters=2000, abstol=1e-10, inner_steps=100)
    seconds = time.perf_counter() - t0
    graph = _require_graph("dae", sol.original)
    print(f"[ode] solve_dae, u1' = u1, 0 = u1 + u2 on [0, 1], mlp([1,{HIDDEN},"
          f"{HIDDEN},2]) f32, dt 0.05, Adam(5e-3): {sol.original.iterations} "
          f"steps in {seconds:.2f} s; errors {sol.errors} (limit l2 < "
          f"{ODE_L2_LIMIT}); {graph}; {card}")
    if not sol.errors["l2"] < ODE_L2_LIMIT:
        raise AssertionError(f"dae: l2 {sol.errors['l2']}")

    # Gauss-Newton on the NNODE objective
    t0 = time.perf_counter()
    sol = npde.solve_ode_gauss_newton(
        _oscillator(f, p=one), npde.NNODE(net(), autodiff=True),
        dt=np.pi / 40, maxiters=40, cg_iters=100)
    seconds = time.perf_counter() - t0
    hist = sol.original.history
    print(f"[ode] solve_ode_gauss_newton, the same system, GridTraining("
          f"pi/40), forward-mode du/dt, LM with 100 CG iterations (2 eager, "
          f"a capture, replays): {sol.original.iterations} outer iterations "
          f"in {seconds:.2f} s; objective {hist[0]:.4g} -> {hist[-1]:.4g}; "
          f"errors {sol.errors} (limit l2 < {ODE_GN_L2_LIMIT}); {card}")
    if not sol.errors["l2"] < ODE_GN_L2_LIMIT:
        raise AssertionError(f"ode gauss-newton: l2 {sol.errors['l2']}")

    # neural_adapter: a trained 2-D Poisson net onto a smaller one
    prob = _poisson(npde.StochasticTraining(ADAPTIVE_BATCH,
                                            bcs_points=ADAPTIVE_BATCH // 8),
                    "cuda")
    t0 = time.perf_counter()
    trained = npde.solve(prob, npde.adam(2e-3), maxiters=3000, inner_steps=100)
    big = npde.depvar_params(trained.u)
    big_net = prob.pinnrep.phi.module
    small_net = npde.mlp([2, 32, 32, 1])
    small_net.reset_parameters(torch.Generator().manual_seed(0))

    scale = 2 * np.pi ** 2      # 1 / max of the exact solution

    def loss(cord, theta):
        return scale * (functional_call(small_net, theta, (cord,))
                        - functional_call(big_net, big, (cord,)))[0]

    from neuralpde_tpu_torch.accuracy import poisson_2d_system

    adapter = npde.neural_adapter(
        loss, {k: v.detach() for k, v in small_net.named_parameters()},
        poisson_2d_system(), npde.QuadratureTraining(order=8, panels=4))
    res = npde.solve(adapter, npde.adam(1e-2), maxiters=10_000,
                     inner_steps=100)
    seconds = time.perf_counter() - t0
    g = np.linspace(0, 1, 41)
    cord = torch.as_tensor(np.stack([a.ravel() for a in np.meshgrid(
        g, g, indexing="ij")]), dtype=torch.float32, device="cuda")
    with torch.no_grad():
        want = functional_call(big_net, big, (cord,))
        got = functional_call(small_net, res.u, (cord,))
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    graph = _require_graph("adapter", res)
    print(f"[ode] neural_adapter, mlp([2,{HIDDEN},{HIDDEN},1]) trained 3000 "
          f"steps on 2-D Poisson (loss {trained.history[0]:.4g} -> "
          f"{trained.objective:.4g}) onto mlp([2,32,32,1]), "
          f"QuadratureTraining(order=8, panels=4), Adam(1e-2) 10000 steps: "
          f"both in {seconds:.2f} s; adapter loss {res.history[0]:.4g} -> "
          f"{res.objective:.4g}; rel L2 of small against big on a 41^2 "
          f"grid {rel:.4f} (limit {ADAPTER_LIMIT}); {graph}; {card}")
    if not rel < ADAPTER_LIMIT:
        raise AssertionError(f"adapter: rel difference {rel}")


def _add(total: dict, counts: dict) -> dict:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return total


def _cpu_init(prob) -> dict:
    """A problem's initial parameters under the module's own names, on the
    CPU: `init_params` for the same problem on another device."""
    return {k[len("depvar."):]: v.cpu() for k, v in prob.init_params.items()}


def phase_zoo_card_vs_cpu(card: str) -> dict:
    """Each trial function of the zoo under a second-order residual on a
    32-node grid an axis: the card against the CPU (same parameters), and
    the Taylor rule against the nested-jvp engine on the card."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_1d_system, poisson_2d_system
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from torch import nn

    zoo = {
        "FBPINN([(0,1)], subdivisions=4, hidden=(16,))": (
            poisson_1d_system, lambda: npde.FBPINN(
                [(0, 1)], subdivisions=4, hidden=(16,)), True),
        "FBPINN([(0,1)]*2, levels=[1,2,4], hidden=(16,))": (
            poisson_2d_system, lambda: npde.FBPINN(
                [(0, 1)] * 2, levels=list(ZOO_LEVELS), hidden=(16,)), True),
        "kan([2,8,8,1], degree=5)": (
            poisson_2d_system, lambda: npde.kan([2, 8, 8, 1], degree=5), True),
        "DGM(2,1,24,3)": (
            poisson_2d_system, lambda: npde.DGM(2, 1, 24, 3), True),
        "TorchModuleAdapter(Linear-Tanh-Linear-Tanh-Linear, width 64)": (
            poisson_2d_system, lambda: npde.TorchModuleAdapter(nn.Sequential(
                nn.Linear(2, HIDDEN), nn.Tanh(), nn.Linear(HIDDEN, HIDDEN),
                nn.Tanh(), nn.Linear(HIDDEN, 1)), 2, 1), False),
    }
    total: dict = {}
    for name, (system, make, ruled) in zoo.items():
        net = make()
        if net.has_taylor_rule != ruled:
            raise AssertionError(f"zoo ({name}): has_taylor_rule "
                                 f"{net.has_taylor_rule}")

        def build(device, mode, init):
            return npde.discretize(system(), npde.PhysicsInformedNN(
                net, npde.GridTraining(ZOO_GRID), derivative=mode,
                dtype=torch.float32, device=device, init_params=init,
                matmul_precision="highest"))

        cpu = build("cpu", "jet", None)
        init = _cpu_init(cpu)
        want = _loss_and_grad_norm(cpu)
        tj.reset_launch_counts()
        got = _loss_and_grad_norm(build("cuda", "jet", init))
        torch.cuda.synchronize()
        counts = tj.launch_counts()
        _add(total, counts)
        nested = _loss_and_grad_norm(build("cuda", "jvp", init))
        d_cpu = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        d_jvp = [abs(g - w) / abs(w) for g, w in zip(got, nested)]
        print(f"[zoo-card-vs-cpu] {name}, GridTraining(1/31), jet, f32 "
              f"highest: loss {got[0]:.9g} vs CPU {want[0]:.9g} (rel "
              f"{d_cpu[0]:.2e}), grad norm {got[1]:.9g} vs {want[1]:.9g} (rel "
              f"{d_cpu[1]:.2e}; limits {CARD_VS_CPU_RTOL}); Taylor rule vs "
              f"nested jvp on the card: loss rel {d_jvp[0]:.2e}, grad norm "
              f"rel {d_jvp[1]:.2e} (limit {TRANSFORM_RTOL}); launches "
              f"{counts}; {card}")
        if not all(map(math.isfinite, (*got, *want, *nested))):
            raise AssertionError(f"zoo ({name}): non-finite values")
        if (d_cpu[0] > CARD_VS_CPU_RTOL["loss"]
                or d_cpu[1] > CARD_VS_CPU_RTOL["grad_norm"]):
            raise AssertionError(f"zoo ({name}): the card disagrees with "
                                 "the CPU")
        if max(d_jvp) > TRANSFORM_RTOL:
            raise AssertionError(f"zoo ({name}): the Taylor rule disagrees "
                                 "with nested jvp")
        if ruled:
            _require_launched(f"zoo ({name})", counts, "tanh_jet2_forward",
                              "tanh_jet2_backward")
        elif any(counts.values()):
            raise AssertionError(f"zoo ({name}): launches without a Taylor "
                                 f"rule: {counts}")
    return total


def _timed_solve(prob, optimizer, maxiters: int, block: int, *,
                 cap_s: float | None = None, **kw):
    """`solve` with the launch counts set to 0 just before and read just
    after: ``(result, seconds, ms per replayed step, counts, peak GiB)``;
    the step time is taken over the blocks after the first (which holds
    the eager step and the capture).  ``cap_s`` ends the run at the first
    block boundary past that many seconds."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    stamps = []

    def stamp(it, loss, aux):
        torch.cuda.synchronize()
        stamps.append((it, time.perf_counter()))
        return cap_s is not None and stamps[-1][1] - t0 > cap_s

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tj.reset_launch_counts()
    t0 = time.perf_counter()
    res = npde.solve(prob, optimizer, maxiters=maxiters, inner_steps=block,
                     callback=stamp, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = tj.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = stamps[-1][0] - stamps[0][0]
    ms = 1e3 * (stamps[-1][1] - stamps[0][1]) / steps if steps else math.nan
    return res, seconds, ms, counts, peak_gib


def _require_counts(what: str, counts: dict, launched: bool) -> None:
    """A path that takes second derivatives by Taylor mode launches the
    forward and backward kernels; one that takes none launches nothing."""
    if launched:
        _require_launched(what, counts, "tanh_jet2_forward",
                          "tanh_jet2_backward")
    elif any(counts.values()):
        raise AssertionError(f"{what}: launches on a path without second "
                             f"derivatives: {counts}")


def phase_fbpinn(card: str) -> dict:
    """`examples/fbpinn_multiscale.py` at its width: the two-scale ODE with
    50 subdomains beside a single MLP, then the five-level Laplace
    hierarchy under a cap of `LAPLACE_CAP_S` seconds."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch import accuracy as acc

    total: dict = {}
    rels = {}
    for name, net in (
            ("FBPINN([(-2pi,2pi)], subdivisions=50, hidden=(16,))",
             acc.two_scale_fbpinn()),
            ("mlp([1,64,64,64,1])", npde.mlp([1, 64, 64, 64, 1]))):
        prob = acc.two_scale_ode(net)
        res, seconds, ms, counts, peak = _timed_solve(
            prob, npde.adam(1e-3), FBPINN_STEPS, FBPINN_BLOCK)
        _add(total, counts)
        rels[name] = acc.two_scale_rel_l2(prob, res.u)
        print(f"[fbpinn] two-scale ODE, 50 fast periods, tanh(w2 x)*NN, "
              f"GridTraining(4pi/1200), Adam(1e-3) f32, {name}: "
              f"{res.iterations} steps in {seconds:.2f} s, {ms:.4f} ms/step "
              f"replayed; loss {res.history[0]:.5g} -> {res.objective:.5g}; "
              f"rel L2 on 4001 points {rels[name]:.4e}; peak {peak:.3f} GiB; "
              f"{_require_graph(name, res)}; launches {counts}; {card}")
        _require_falling(f"fbpinn ode ({name})", res.history)
        _require_counts(f"fbpinn ode ({name})", counts, False)
    fb, single = rels.values()
    print(f"[fbpinn] two-scale ODE rel L2: FBPINN {fb:.4e} (limit "
          f"{FBPINN_ODE_LIMIT} and below the MLP's), single MLP {single:.4e}; "
          f"the JAX package on a TPU: {FBPINN_ODE_JAX[0]} and "
          f"{FBPINN_ODE_JAX[1]}")
    if not (fb < FBPINN_ODE_LIMIT and fb < single):
        raise AssertionError(f"fbpinn ode: rel L2 {fb} (MLP {single})")

    prob = acc.multiscale_laplace()
    net = prob.pinnrep.phi.module.base
    nodes = 129 * 129
    if net.level_subs != [[j, j] for j in LAPLACE_LEVELS]:
        raise AssertionError(f"fbpinn laplace: levels {net.level_subs}")
    res, seconds, ms, counts, peak = _timed_solve(
        prob, npde.adam(1e-3), FBPINN_STEPS, LAPLACE_BLOCK,
        cap_s=LAPLACE_CAP_S)
    _add(total, counts)
    rel = acc.multiscale_laplace_rel_l2(prob, res.u)
    print(f"[fbpinn] 2-D multi-scale Laplace L=4, FBPINN levels "
          f"[1,2,4,8,16] ({net.n_subdomains} local nets of hidden 16), hard "
          f"constraint, GridTraining(1/128) ({nodes} nodes), jet, Adam(1e-3) "
          f"f32 highest: {res.iterations} of the example's {FBPINN_STEPS} "
          f"steps in {seconds:.2f} s (cap {LAPLACE_CAP_S} s), {ms:.3f} "
          f"ms/step replayed, {nodes * 1e3 / ms:.6g} nodes/s; loss "
          f"{res.history[0]:.5g} -> {res.objective:.5g}; rel L2 on 257^2 "
          f"{rel:.4e}; peak {peak:.3f} GiB; {_require_graph('laplace', res)}; "
          f"launches counted (eager step and capture) {counts}; {card}")
    _require_falling("fbpinn laplace", res.history)
    _require_counts("fbpinn laplace", counts, True)

    _profile_solve(prob, npde.adam(1e-3), 20, 10, ms / 1e3)
    return total


def phase_weak(card: str) -> dict:
    """The front problem at 96^2 nodes: strong form, `WeakTraining` at ibp
    0, 1 and 2, and `solve_weak_adaptive`; then the smooth 2-D problem and
    Gauss-Newton on weak rows, each at the bound of the JAX package's own
    test."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch import accuracy as acc
    from neuralpde_tpu_torch.gauss_newton import _EAGER_STEPS
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    total: dict = {}
    system = acc.front_system()
    nodes = (acc.FRONT_MESH["elements"] * acc.FRONT_MESH["quad"]) ** 2

    def weak(ibp):
        return npde.WeakTraining(ibp=ibp, **acc.FRONT_MESH)

    runs = {"strong GridTraining(1/95)": (npde.GridTraining(1.0 / 95), True),
            "WeakTraining ibp=0": (weak(0), True),
            "WeakTraining ibp=1": (weak(1), False),
            "WeakTraining ibp=2": (weak(2), False)}
    for name, (strategy, launched) in runs.items():
        disc = acc.front_discretization(strategy)
        prob = npde.discretize(system, disc)
        res, seconds, ms, counts, peak = _timed_solve(
            prob, npde.adam(2e-3), WEAK_STEPS, WEAK_BLOCK)
        _add(total, counts)
        rel = acc.front_rel_l2(disc.phi, res.u)
        print(f"[weak] front tanh(60(x-0.7)) sin(pi y), mlp([2,{HIDDEN},"
              f"{HIDDEN},1]) jet, E=8 K=8 q=12 ({nodes} nodes), Adam(2e-3) "
              f"f32, {name}: {ms:.4f} ms/step replayed, {res.iterations} "
              f"steps in {seconds:.2f} s; loss {res.history[0]:.5g} -> "
              f"{res.objective:.5g}; rel L2 on 201^2 {rel:.4e}; peak "
              f"{peak:.3f} GiB; {_require_graph(name, res)}; launches "
              f"counted (eager step and capture) {counts}; {card}")
        _require_falling(f"weak ({name})", res.history)
        _require_counts(f"weak ({name})", counts, launched)

    disc = acc.front_discretization(weak(1))
    tj.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ares = npde.solve_weak_adaptive(
        system, disc, npde.adam(2e-3), rounds=len(WEAK_ROUNDS),
        maxiters=list(WEAK_ROUNDS), mode="hp", inner_steps=WEAK_BLOCK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = tj.launch_counts()
    _add(total, counts)
    rel = acc.front_rel_l2(ares.prob.pinnrep.phi, ares.u)
    rounds = []
    for strat, r in zip(ares.strategies, ares.results):
        def per_axis(value, count):
            return {ax: (count(v) if np.ndim(v) else int(v))
                    for ax, v in value.items()} if isinstance(value, dict) \
                else int(value)

        rounds.append({
            "elements": per_axis(strat.elements, lambda e: len(e) - 1),
            "n_test": per_axis(strat.n_test,
                               lambda k: [int(i) for i in np.asarray(k)]),
            "steps": r.iterations, "objective": round(r.objective, 6),
            "graph": _require_graph("weak adaptive", r)})
    print(f"[weak] the same front, solve_weak_adaptive(rounds=3, mode='hp') "
          f"from the ibp=1 mesh, {ares.iterations} steps in {seconds:.2f} s, "
          f"{1e3 * seconds / ares.iterations:.4f} ms/step with refinement and "
          f"captures; rel L2 on 201^2 {rel:.4e}; per round {rounds}; launches "
          f"{counts}; {card}")
    _require_falling("weak adaptive", ares.history)
    _require_counts("weak adaptive", counts, False)
    if len(ares.strategies) != len(WEAK_ROUNDS):
        raise AssertionError("weak adaptive: a round is missing")

    # the smooth 2-D problem of the JAX package's test, at its bound
    disc = npde.PhysicsInformedNN(
        npde.mlp([2, 16, 16, 1]), npde.WeakTraining(elements=4, n_test=6,
                                                     ibp=1))
    prob = npde.discretize(acc.poisson_2d_system(), disc)
    res, seconds, ms, counts, _ = _timed_solve(prob, npde.adam(2e-2), 1200, 50)
    rel = acc.poisson_2d_rel_l2(disc.phi, res.u)
    print(f"[weak] smooth 2-D Poisson, mlp([2,16,16,1]), WeakTraining("
          f"elements=4, n_test=6, ibp=1), Adam(2e-2) f32: {res.iterations} "
          f"steps in {seconds:.2f} s, {ms:.4f} ms/step; loss "
          f"{res.history[0]:.5g} -> {res.objective:.5g}; rel L2 on 21^2 "
          f"{rel:.4e} (limit {WEAK_SMOOTH_LIMIT}); "
          f"{_require_graph('weak smooth', res)}; {card}")
    if not rel < WEAK_SMOOTH_LIMIT:
        raise AssertionError(f"weak smooth: rel L2 {rel}")

    # Gauss-Newton on weak rows (1-D Poisson), its inner CG step captured
    disc = npde.PhysicsInformedNN(
        npde.mlp([1, 16, 16, 1]), npde.WeakTraining(elements=6, n_test=8,
                                                     ibp=1))
    prob = npde.discretize(acc.poisson_1d_system(), disc)
    t0 = time.perf_counter()
    res = npde.solve_gauss_newton(prob, maxiters=60, cg_iters=100)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rel = acc.poisson_1d_rel_l2(disc.phi, res.u)
    graph = res.aux["cuda_graph"]
    print(f"[weak] solve_gauss_newton on weak rows, 1-D Poisson, mlp([1,16,"
          f"16,1]), WeakTraining(elements=6, n_test=8, ibp=1), f32 highest, "
          f"LM with 100 CG iterations: {res.iterations} outer iterations in "
          f"{seconds:.2f} s ({seconds / max(res.iterations, 1):.3f} s each); "
          f"objective {res.history[0]:.4e} -> {res.objective:.4e} (limit "
          f"{WEAK_GN_LIMITS[1]}); rel L2 {rel:.4e} (limit "
          f"{WEAK_GN_LIMITS[0]}); inner CG step: {_EAGER_STEPS} eager steps "
          f"an outer iteration, {graph['captures']} graph captures, "
          f"{graph['replays']} replays; {card}")
    if not (rel < WEAK_GN_LIMITS[0] and res.objective < WEAK_GN_LIMITS[1]):
        raise AssertionError(f"weak gauss-newton: rel L2 {rel}, objective "
                             f"{res.objective}")
    if graph["captures"] < 1 or graph["replays"] < graph["captures"] * (
            100 - _EAGER_STEPS):
        raise AssertionError("weak gauss-newton: the inner step was not "
                             "captured")

    # the same with ibp=0 rows: second derivatives stay on the net, so J v
    # is the jvp of a Taylor-mode residual (the tanh_jet2_jvp kernel)
    disc = npde.PhysicsInformedNN(
        npde.mlp([1, 16, 16, 1]), npde.WeakTraining(elements=6, n_test=8,
                                                     ibp=0),
        derivative="jet")
    prob = npde.discretize(acc.poisson_1d_system(), disc)
    tj.reset_launch_counts()
    t0 = time.perf_counter()
    res = npde.solve_gauss_newton(prob, maxiters=20, cg_iters=100,
                                  damping=1.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = tj.launch_counts()
    _add(total, counts)
    print(f"[weak] solve_gauss_newton on ibp=0 weak rows (jet), the same "
          f"problem, damping 1: {res.iterations} outer iterations in "
          f"{seconds:.2f} s; objective {res.history[0]:.4e} -> "
          f"{res.objective:.4e}; launches counted (eager steps and "
          f"captures) {counts}; {card}")
    _require_launched("weak gauss-newton ibp=0", counts, "tanh_jet2_forward",
                      "tanh_jet2_jvp", "tanh_jet2_backward")
    if not res.objective < 1e-2 * res.history[0]:
        raise AssertionError(f"weak gauss-newton ibp=0: objective "
                             f"{res.history[0]} -> {res.objective}")
    return total


def phase_zoo_solvers(card: str) -> dict:
    """`examples/burgers_dgm.py` (and its configuration on the travelling
    wave, which has an exact solution), a KAN on bench's Poisson problem,
    and Deep Ritz with Monte-Carlo energy."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch import accuracy as acc
    from neuralpde_tpu_torch.nn import identity, tanh

    total: dict = {}

    def dgm():
        # the example's discretization; the port's `identity` stands for
        # its ``lambda z: z`` so that the output layer has a Taylor rule
        return npde.DeepGalerkin(
            2, 1, 24, 3, tanh, tanh, identity,
            npde.QuasiRandomTraining(512, sampling_alg="sobol"),
            adaptive_loss=npde.MiniMaxAdaptiveLoss(100), derivative="jet")

    for name, system, steps, exact in (
            (f"examples/burgers_dgm.py (nu 0.05, -sin(pi x); cut to "
             f"{DGM_EXAMPLE_STEPS} of its {DGM_STEPS} steps)",
             acc.burgers_dgm_example(), DGM_EXAMPLE_STEPS, False),
            ("the travelling wave c - a tanh(a(x - ct)/2nu)",
             acc.burgers_wave_system(), DGM_STEPS, True)):
        disc = dgm()
        prob = npde.discretize(system, disc)
        res, seconds, ms, counts, peak = _timed_solve(
            prob, npde.adam(1e-2), steps, 25)
        _add(total, counts)
        line = (f"[zoo-solvers] DeepGalerkin(2,1,24,3,tanh,tanh,identity), "
                f"QuasiRandomTraining(512, 'sobol'), MiniMaxAdaptiveLoss(100)"
                f", jet, Adam(1e-2) f32, {name}: {res.iterations} steps in "
                f"{seconds:.2f} s, {ms:.4f} ms/step replayed; loss "
                f"{res.history[0]:.5g} -> {res.objective:.5g}; peak "
                f"{peak:.3f} GiB; {_require_graph(name, res)}; "
                f"launches counted (eager steps and captures) {counts}")
        _require_falling(f"dgm ({name})", res.history)
        _require_counts(f"dgm ({name})", counts, True)
        if res.aux["cuda_graph"]["captures"] != 2:
            raise AssertionError(f"dgm ({name}): expected the plain and the "
                                 "reweighting step captured")
        if exact:
            err = acc.burgers_wave_max_error(disc.phi, res.u)
            line += f"; maximum error on 21^2 {err:.4e} (limit {DGM_LIMIT})"
            if not err < DGM_LIMIT:
                raise AssertionError(f"dgm: maximum error {err}")
        print(f"{line}; {card}")
        if not exact:
            _profile_solve(prob, npde.adam(1e-2), 10, 5, ms / 1e3)

    # bench's Poisson problem under time_to_l2_hard's hard constraint: with
    # penalized boundary values this KAN stays at rel L2 0.6-0.8 after 2,000
    # steps (0.42 after 6,000) on an H100, at any of four step sizes
    disc = npde.PhysicsInformedNN(
        npde.Transformed(npde.kan([2, 8, 8, 1], degree=5), acc._hard_box),
        npde.StochasticTraining(ADAPTIVE_BATCH,
                                bcs_points=ADAPTIVE_BATCH // 8),
        derivative="jet", dtype=torch.float32)
    prob = npde.discretize(acc.poisson_2d_system(), disc)
    res, seconds, ms, counts, peak = _timed_solve(prob, npde.adam(2e-2),
                                                  2000, 100)
    _add(total, counts)
    rel = acc.poisson_2d_rel_l2(disc.phi, res.u, 51)
    print(f"[zoo-solvers] x(1-x)y(1-y) * kan([2,8,8,1], degree=5), bench's "
          f"2-D Poisson, StochasticTraining({ADAPTIVE_BATCH}, bcs_points="
          f"{ADAPTIVE_BATCH // 8}), jet, Adam(2e-2) f32: {res.iterations} "
          f"steps in {seconds:.2f} s, {ms:.4f} ms/step replayed; loss "
          f"{res.history[0]:.5g} -> {res.objective:.5g}; rel L2 on 51^2 "
          f"{rel:.4e} (limit {KAN_LIMIT}); peak {peak:.3f} GiB; "
          f"{_require_graph('kan', res)}; launches counted {counts}; {card}")
    _require_counts("kan", counts, True)
    if not rel < KAN_LIMIT:
        raise AssertionError(f"kan: rel L2 {rel}")
    _profile_solve(prob, npde.adam(2e-2), 20, 10, ms / 1e3)

    prob = acc.ritz_poisson_2d(npde.StochasticTraining(4096))
    res, seconds, ms, counts, peak = _timed_solve(prob, npde.adam(3e-3),
                                                  3000, 100)
    rel = acc.poisson_2d_rel_l2(prob.pinnrep.phi, res.u, 65, scale=1.0)
    print(f"[zoo-solvers] DeepRitz, -Lap u = 2 pi^2 sin sin, hard-constrained "
          f"mlp([2,32,32,1]), StochasticTraining(4096) Monte-Carlo energy, "
          f"Adam(3e-3) f32: {res.iterations} steps in {seconds:.2f} s, "
          f"{ms:.4f} ms/step replayed; energy {res.history[0]:.5g} -> "
          f"{float(res.aux['energy']):.5g} (minimum -pi^2/4 = "
          f"{-np.pi ** 2 / 4:.5g}); rel L2 on 65^2 {rel:.4e} (limit "
          f"{RITZ_LIMIT}); {_require_graph('ritz', res)}; launches {counts}; "
          f"{card}")
    _require_counts("ritz", counts, False)
    if not rel < RITZ_LIMIT:
        raise AssertionError(f"ritz: rel L2 {rel}")
    return total


# --- the stochastic layer (phases 24-26) -----------------------------------

def _lotka_volterra_bnnode(npde, draws: int, n_leapfrog: int):
    """tests/test_bayesian.py:116-156: the four-parameter Lotka-Volterra
    inverse problem of examples/lotka_volterra_bpinn.py (RK4 data with 1%
    noise, `estim_collocate`) with the test's sigmoid net and 400
    ensemble draws."""
    from neuralpde_tpu_torch.examples import lotka_volterra_bpinn as lv

    alg = lv.make_alg(draws, n_leapfrog,
                      chain=npde.mlp([1, 16, 16, 2], activation=torch.sigmoid),
                      numensemble=400)
    return lv.lotka_volterra_problem(), alg, lv.P_TRUE


def _bpinn_poisson(npde, width: int, dx: float, activation, derivative,
                   device="cuda"):
    """tests/test_bpinn_pde.py:97's 2-D Poisson as a `BayesianPINN`."""
    from neuralpde_tpu_torch.accuracy import poisson_2d_system

    disc = npde.BayesianPINN(npde.mlp([2, width, width, 1]
                                      if width == HIDDEN else [2, width, 1],
                                      activation=activation),
                             npde.GridTraining(dx), derivative=derivative,
                             device=device)
    return poisson_2d_system(), disc


def _value_grad_norm(fn, theta) -> tuple[float, float]:
    q = theta.detach().clone().requires_grad_(True)
    v = fn(q)
    (g,) = torch.autograd.grad(v, q)
    return float(v.detach()), float(g.double().norm())


def _card_vs_cpu_line(what, cpu, card,
                      tag: str = "stochastic-card-vs-cpu") -> None:
    (cl, cn), (gl, gn) = cpu, card
    d_loss = abs(gl - cl) / max(abs(cl), 1e-30)
    d_norm = abs(gn - cn) / max(abs(cn), 1e-30)
    print(f"[{tag}] {what}: value {gl:.9g} vs {cl:.9g} (rel "
          f"{d_loss:.2e}), grad norm {gn:.9g} vs {cn:.9g} (rel {d_norm:.2e}); "
          f"limits {CARD_VS_CPU_RTOL}")
    if not all(map(math.isfinite, (cl, cn, gl, gn))):
        raise AssertionError(f"{what}: non-finite value or gradient")
    if d_loss > CARD_VS_CPU_RTOL["loss"] or d_norm > CARD_VS_CPU_RTOL["grad_norm"]:
        raise AssertionError(f"{what}: the card disagrees with the CPU")


def phase_stochastic_card_vs_cpu(card: str) -> None:
    """`inner_sde_loss` (weak, strong), the BNNODE log-density
    (Lotka-Volterra with data and `estim_collocate`) and the BPINN
    log-density (2-D Poisson, mlp([2,64,64,1]), jet) on the card and the
    CPU from the same parameters and draws; then one HMC chain of 30
    draws captured against the same chain run eagerly."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.bayesian import hmc
    from neuralpde_tpu_torch.bayesian.pde import PDELogTargetDensity
    from neuralpde_tpu_torch.solvers import sde
    from neuralpde_tpu_torch.examples.gbm_sde import gbm_problem

    net = npde.mlp([4, 16, 16, 1], activation=torch.sigmoid)
    net.reset_parameters(torch.Generator().manual_seed(3))
    params = {f"depvar.{k}": v.detach().clone()
              for k, v in net.named_parameters()}
    prob = gbm_problem()
    g = torch.Generator().manual_seed(4)
    ts = torch.linspace(0, 1, 51)
    for strong, mk in ((False, sde.add_rand_coeff),
                       (True, sde.add_rand_coeff_2)):
        inputs = mk(g, ts, 3, 8, torch.float32)
        out = {}
        for dev in ("cpu", "cuda"):
            theta = {k: v.to(dev).requires_grad_(True)
                     for k, v in params.items()}
            phi = sde.SDEPhi(net, 0.0, 1.0, like=theta["depvar.layer_0.weight"])
            loss = sde.inner_sde_loss(phi, prob.f, prob.g, True,
                                      inputs.to(dev), theta, None, False,
                                      strong, True)
            grads = torch.autograd.grad(loss, list(theta.values()))
            out[dev] = (float(loss.detach()), math.sqrt(sum(
                float((gr.double() ** 2).sum()) for gr in grads)))
        _card_vs_cpu_line(f"inner_sde_loss {'strong' if strong else 'weak'}, "
                          "GBM, mlp([4,16,16,1]), (4, 51, 8) draws, f32",
                          out["cpu"], out["cuda"])

    lv, lv_alg, _ = _lotka_volterra_bnnode(npde, 0, 25)
    lv_alg.chain.reset_parameters(torch.Generator().manual_seed(0))
    lv_init = {k: v.detach().clone()
               for k, v in lv_alg.chain.named_parameters()}

    def lv_density(device):
        return npde.ahmc_bayesian_pinn_ode(
            lv, lv_alg.chain, dataset=lv_alg.dataset, draw_samples=0,
            l2std=lv_alg.l2std, phystd=lv_alg.phystd,
            priorsNNw=lv_alg.priorsNNw, param=lv_alg.param,
            estim_collocate=True, init_params=lv_init, device=device)[2]

    out = {}
    for dev in ("cpu", "cuda"):
        ltd = lv_density(dev)
        theta = torch.cat([ltd.init_flat_nn, torch.tensor(
            [1.4, 0.9, 2.8, 1.1], device=dev)])
        out[dev] = _value_grad_norm(ltd, theta)
    _card_vs_cpu_line("LogTargetDensity, Lotka-Volterra, mlp([1,16,16,2]), "
                      "data + estim_collocate, f32", out["cpu"], out["cuda"])

    out, init = {}, None
    for dev in ("cpu", "cuda"):
        system, disc = _bpinn_poisson(npde, HIDDEN, ZOO_GRID, torch.tanh,
                                      "jet", dev)
        disc.init_params = init
        rep = npde.symbolic_discretize(system, disc)
        init = init or {k: v.cpu() for k, v in rep.init_params.items()}
        ltd = PDELogTargetDensity(rep, None, npde.Normal(0.0, 2.0), [],
                                  ([0.05], [0.01] * 4, []), [0.05])
        out[dev] = _value_grad_norm(ltd, ltd.init_flat_nn)
    _card_vs_cpu_line("PDELogTargetDensity, 2-D Poisson, mlp([2,64,64,1]) "
                      "tanh, GridTraining(1/31), jet, f32", out["cpu"],
                      out["cuda"])

    chains = []
    for graphs in (True, False):
        ltd = lv_density("cuda")
        theta0 = torch.cat([ltd.init_flat_nn,
                            torch.tensor([2.0, 1.5, 2.5, 1.5], device="cuda")])
        res = hmc.sample(ltd, theta0, torch.Generator(device="cuda").manual_seed(7),
                         30, n_leapfrog=10, init_step_size=1e-3, graphs=graphs)
        torch.cuda.synchronize()
        chains.append(res)
    a, b = chains
    same = (torch.equal(a.samples, b.samples)
            and torch.equal(a.accept_prob, b.accept_prob))
    print(f"[stochastic-card-vs-cpu] HMC chain of 30 draws (Lotka-Volterra "
          f"BNNODE log-density, n_leapfrog 10): captured "
          f"({a.aux['cuda_graph']['captures']} capture, "
          f"{a.aux['cuda_graph']['replays']} replays) against eager "
          f"({b.aux['cuda_graph']['captures']} captures): bit-equal {same}, "
          f"max |diff| {float((a.samples - b.samples).abs().max()):.3e}, mean "
          f"accept {float(a.accept_prob.mean()):.4f}; {card}")
    if not same or a.aux["cuda_graph"]["replays"] != 29:
        raise AssertionError("the captured HMC chain differs from the eager one")


@contextlib.contextmanager
def _default_dtype(dtype):
    """The solvers work in torch's default dtype: set it for the body."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


def _sol_seconds(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def phase_sde(card: str) -> None:
    """The SDE solvers at the JAX tests' sizes and bounds."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.examples.gbm_sde import gbm_problem

    sig = torch.sigmoid
    alg = npde.NNSDE(npde.mlp([4, 16, 16, 1], activation=sig), npde.adam(2e-2),
                     sub_batch=8, numensemble=50)
    sol, s, peak = _sol_seconds(lambda: npde.solve_sde(
        gbm_problem(), alg, dt=1 / 50, maxiters=2000, inner_steps=25))
    ts = np.asarray(sol.timepoints)
    mean = np.asarray([float(p.mean) for p in sol.estimated_sol[0]])
    rel = float(np.mean(np.abs(mean - np.exp(1.2 * ts)) / np.exp(1.2 * ts)))
    g = sol.original.aux["cuda_graph"]
    print(f"[sde] examples/gbm_sde.py: mlp([4,16,16,1]) sigmoid, sub_batch 8, "
          f"dt 1/50 (51 x 8 inputs), Adam(2e-2) f32, 2000 steps in {s:.2f} s "
          f"({1e3 * s / 2000:.4f} ms a step over the run, eager step and "
          f"capture included); E[u(1)] {mean[-1]:.5f} (exact {np.exp(1.2):.5f})"
          f"; mean rel error vs exp(1.2 t) {rel:.4e} (limit {SDE_GBM_LIMIT}); "
          f"peak {peak:.3f} GiB; {_graph_line(sol.original)}; {card}")
    if not rel < SDE_GBM_LIMIT or g["replays"] != 2000 - 1:
        raise AssertionError(f"sde gbm: rel {rel}, graphs {g}")

    prob = npde.SDEProblem(f=lambda u, p, t: -u, g=lambda u, p, t: 0.1,
                           u0=0.5, tspan=(0.0, 1.0))
    alg = npde.NNSDE(npde.mlp([3, 12, 1], activation=sig), npde.adam(0.02),
                     sub_batch=3, strong_loss=True)
    sol, s, _ = _sol_seconds(lambda: npde.solve_sde(
        prob, alg, dt=1 / 20.0, maxiters=400, abstol=1e-12, inner_steps=25))
    print(f"[sde] strong training (tests/test_sde.py:45), mlp([3,12,1]), 400 "
          f"steps in {s:.2f} s: loss {sol.original.history[0]:.5g} -> "
          f"{sol.original.objective:.5g}; {_graph_line(sol.original)}")
    if not math.isfinite(sol.original.objective):
        raise AssertionError("sde strong: non-finite loss")

    rng = np.random.default_rng(1)
    ts = np.linspace(0.0, 1.0, 80)
    dt = ts[1] - ts[0]
    paths = []
    for _ in range(6):
        x = [1.0]
        for _ in range(len(ts) - 1):
            x.append(x[-1] + 0.8 * x[-1] * dt
                     + 0.1 * x[-1] * np.sqrt(dt) * rng.standard_normal())
        paths.append(np.asarray(x))
    prob = npde.SDEProblem(f=lambda u, p, t: p[0] * u,
                           g=lambda u, p, t: 0.1 * u, u0=1.0, tspan=(0.0, 1.0),
                           p=np.array([0.3]))
    alg = npde.NNSDE(npde.mlp([3, 12, 1], activation=sig), npde.adam(0.02),
                     sub_batch=4, param_estim=True, dataset=[paths, ts])
    sol, s, _ = _sol_seconds(lambda: npde.solve_sde(
        prob, alg, dt=1 / 25.0, maxiters=1500, abstol=1e-12, inner_steps=25))
    mu = sol.estimated_params[0]
    print(f"[sde] inverse EM problem (tests/test_sde.py:56), 1500 steps in "
          f"{s:.2f} s: mu {mu:.5f} (true 0.8, limit |error| < "
          f"{SDE_INVERSE_LIMIT}); {_graph_line(sol.original)}")
    if not abs(mu - 0.8) < SDE_INVERSE_LIMIT:
        raise AssertionError(f"sde inverse: mu {mu}")

    prob = npde.SDEProblem(f=lambda x, p, t: -1.0 * x, g=lambda x, p, t: 0.5,
                           u0=0.0, tspan=(0.0, 3.0))
    chain = npde.mlp([2, 16, 16, 1], activation=torch.tanh,
                     out_activation=npde.nn.softplus)
    alg = npde.SDEPINN(chain=chain, x_0=-2.0, x_end=2.0, Nt=15, dx=0.1,
                       distrib=npde.Normal(0.0, 0.2), optimalg=npde.adam(0.01),
                       lambda_norm=10.0)
    (res, phi, _), s, peak = _sol_seconds(lambda: npde.solve_sde_weak(
        prob, alg, maxiters=2500, inner_steps=25))
    xs = np.linspace(-2, 2, 41)
    with torch.no_grad():
        dens = phi(np.stack([xs, np.full_like(xs, 3.0)]),
                   npde.depvar_params(res.u))[0].double().cpu().numpy()
    var = 0.5 ** 2 / 2
    want = np.exp(-xs**2 / (2 * var)) / np.sqrt(2 * np.pi * var)
    err = float(np.max(np.abs(dens / np.trapezoid(dens, xs) - want)))
    print(f"[sde] OU Fokker-Planck SDEPINN (tests/test_sde.py:82): "
          f"mlp([2,16,16,1]) tanh/softplus, 41 x 16 grid, Adam(1e-2) f32, "
          f"2500 steps in {s:.2f} s ({1e3 * s / 2500:.4f} ms a step over the "
          f"run); loss {res.history[0]:.5g} -> {res.objective:.5g}; max "
          f"density error at t = 3 {err:.4e} (limit {SDE_OU_LIMIT}); peak "
          f"{peak:.3f} GiB; {_require_graph('sdepinn', res)}; {card}")
    if not err < SDE_OU_LIMIT:
        raise AssertionError(f"sdepinn: density error {err}")


def _chain_line(samples, n_params: int, seconds: float) -> str:
    """ESS/s and split-R-hat of the last ``n_params`` coordinates over the
    post-warm-up third of the chain."""
    from neuralpde_tpu_torch import ess, split_rhat

    tail = samples[(2 * samples.shape[0]) // 3:, -n_params:].double().cpu()
    e, r = ess(tail.numpy()), split_rhat(tail.numpy())
    return (f"ESS {np.array2string(e, precision=1)} "
            f"({np.array2string(e / seconds, precision=2)} /s), split-R-hat "
            f"{np.array2string(r, precision=4)}")


def phase_bayesian(card: str) -> dict:
    """HMC and NUTS on the JAX tests' Gaussians, BNNODE Lotka-Volterra at
    its full configuration, the BPINN 2-D Poisson at its test's size, and
    the kernel path: the same Poisson at mlp([2,64,64,1]), jet."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.bayesian import hmc
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    mu = torch.tensor([1.0, -2.0], device="cuda")
    sigma = torch.tensor([0.5, 2.0], device="cuda")
    res, s, _ = _sol_seconds(lambda: hmc.sample(
        lambda q: -0.5 * torch.sum(((q - mu) / sigma) ** 2),
        torch.zeros(2, device="cuda"), seed=0, draw_samples=4000,
        n_leapfrog=20, init_step_size=0.25))
    tail = res.samples[3000:].cpu().numpy()
    ok = (np.all(np.abs(tail.mean(0) - [1.0, -2.0]) < 0.3)
          and np.all(np.abs(tail.std(0) / [0.5, 2.0] - 1) < 0.3)
          and float(res.accept_prob[3000:].mean()) > 0.5)
    print(f"[bayesian] HMC on tests/test_bayesian.py:16's Gaussian, 4000 "
          f"draws, n_leapfrog 20: {s:.2f} s ({1e3 * s / 4000:.4f} ms a draw); "
          f"mean {tail.mean(0)}, std {tail.std(0)}, accept "
          f"{float(res.accept_prob[3000:].mean()):.3f}; graphs "
          f"{res.aux['cuda_graph']}; within the test's bands {ok}")
    if not ok:
        raise AssertionError("hmc gaussian outside the bands")

    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32, device="cuda")
    res, s, _ = _sol_seconds(lambda: hmc.sample(
        lambda q: -0.5 * q @ prec @ q, torch.zeros(2, device="cuda") + 3.0,
        seed=0, draw_samples=2600, kernel="nuts", max_depth=6,
        init_step_size=0.2))
    tail = res.samples[1750:].cpu().numpy()
    ok = (np.all(np.abs(tail.mean(0)) < 0.3)
          and np.all(np.abs(np.cov(tail.T) - cov) < 0.4))
    print(f"[bayesian] NUTS on tests/test_bayesian.py:33's correlated "
          f"Gaussian, 2600 draws, max_depth 6: {s:.2f} s "
          f"({1e3 * s / 2600:.4f} ms a draw, a host loop over the captured "
          f"leapfrog step); mean {tail.mean(0)}, cov "
          f"{np.cov(tail.T).ravel()}; graphs {res.aux['cuda_graph']}; within "
          f"the test's bands {ok}")
    if not ok:
        raise AssertionError("nuts gaussian outside the bands")

    # float64, as the JAX test runs it: the density is ~-1.5e6 at the
    # start, where float32's spacing quantizes the energy differences of
    # the Metropolis test and dual averaging shrinks the step size to ~1e-9
    prob, alg, p_true = _lotka_volterra_bnnode(npde, 1200, 25)
    with _default_dtype(torch.float64):
        sol, s, peak = _sol_seconds(lambda: npde.solve_bnnode(prob, alg))
    est = np.array([float(p.mean) for p in sol.estimated_de_params])
    rel = np.abs(est - p_true) / p_true
    graph = sol.original.statistics["cuda_graph"]
    print(f"[bayesian] BNNODE Lotka-Volterra (tests/test_bayesian.py:116-156: "
          f"mlp([1,16,16,2]) sigmoid, 1200 draws, n_leapfrog 25, "
          f"estim_collocate), f64: {s:.2f} s, {1200 / s:.2f} draws/s, "
          f"{1200 * 25 / s:.1f} gradient evaluations/s, peak {peak:.3f} GiB; "
          f"{_chain_line(sol.original.samples, 4, s)}; estimates {est} "
          f"against {p_true} (rel {rel}, limit {BNNODE_PARAM_RTOL}); "
          f"step size {sol.original.statistics['step_size']:.4e}; graphs "
          f"{graph}; {card}")
    if not np.all(rel < BNNODE_PARAM_RTOL) or graph["replays"] != 1200 - 1:
        raise AssertionError(f"bnnode lotka-volterra: estimates {est}")

    with _default_dtype(torch.float64):
        system, disc = _bpinn_poisson(npde, 10, 0.2, torch.sigmoid, "jvp")
        sol, s, _ = _sol_seconds(lambda: npde.ahmc_bayesian_pinn_pde(
            system, disc, draw_samples=400, bcstd=[0.01] * 4, phystd=[0.05],
            priorsNNw=(0.0, 2.0), saveats=[0.1, 0.1], n_leapfrog=20))
    cord = sol.timepoints[0].cpu().numpy()
    want = np.sin(np.pi * cord[0]) * np.sin(np.pi * cord[1]) / (2 * np.pi**2)
    rms = float(np.sqrt(np.mean(
        (sol.ensemblesol[0].mean.cpu().numpy() - want) ** 2)))
    print(f"[bayesian] BPINN 2-D Poisson (tests/test_bpinn_pde.py:97: "
          f"mlp([2,10,1]) sigmoid, GridTraining(0.2), 400 draws, n_leapfrog "
          f"20), f64: {s:.2f} s ({1e3 * s / 400:.3f} ms a draw); ensemble "
          f"mean RMS {rms:.4e} (limit {BPINN_RMS_LIMIT}); graphs "
          f"{sol.original.statistics['cuda_graph']}")
    if not rms < BPINN_RMS_LIMIT:
        raise AssertionError(f"bpinn poisson: rms {rms}")

    system, disc = _bpinn_poisson(npde, HIDDEN, ZOO_GRID, torch.tanh, "jet")
    kw = dict(bcstd=[0.01] * 4, phystd=[0.05], priorsNNw=(0.0, 2.0),
              saveats=[0.05, 0.05], n_leapfrog=BPINN_JET_LEAPFROG)
    tj.reset_launch_counts()
    sol, s, peak = _sol_seconds(lambda: npde.ahmc_bayesian_pinn_pde(
        system, disc, draw_samples=BPINN_JET_DRAWS, **kw))
    counts = tj.launch_counts()
    graph = sol.original.statistics["cuda_graph"]
    cord = sol.timepoints[0].cpu().numpy()
    want = np.sin(np.pi * cord[0]) * np.sin(np.pi * cord[1]) / (2 * np.pi**2)
    got = sol.ensemblesol[0].mean.double().cpu().numpy()
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    evals = BPINN_JET_DRAWS * BPINN_JET_LEAPFROG
    print(f"[bayesian] kernel path: BayesianPINN(mlp([2,64,64,1]) tanh, "
          f"GridTraining(1/31), jet) on the 2-D Poisson, {BPINN_JET_DRAWS} "
          f"draws, n_leapfrog {BPINN_JET_LEAPFROG}, f32: {s:.2f} s, "
          f"{1e3 * s / BPINN_JET_DRAWS:.3f} ms a draw, {evals / s:.1f} "
          f"gradient evaluations/s, peak {peak:.3f} GiB; graphs {graph}; "
          f"ensemble mean rel L2 {rel:.4e} (recorded, not bounded); "
          f"launches counted (eager draw and capture) {counts}; {card}")
    _require_launched("bpinn jet sampler", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward")
    if graph["captures"] != 1 or graph["replays"] != BPINN_JET_DRAWS - 1:
        raise AssertionError(f"bpinn jet: draws outside the graph: {graph}")
    _profile_draws(system, disc, kw, 1e3 * s / BPINN_JET_DRAWS)
    return counts


def _profile_draws(system, disc, kw, ms_per_draw: float) -> None:
    """Trace a short run of the jet sampler (1 eager draw, 1 capture, 11
    replays): device busy per draw against the untraced draw time."""
    import neuralpde_tpu_torch as npde
    from torch.profiler import ProfilerActivity, profile

    n = 12
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        npde.ahmc_bayesian_pinn_pde(system, disc, draw_samples=n, **kw)
        torch.cuda.synchronize()
    busy_us = _kernel_us(prof)
    kernels = sorted(_device_events(prof),
                     key=lambda e: -e.self_device_time_total)
    print(f"[profile] {n} draws of the jet sampler (1 eager, 1 captured, "
          f"{n - 1} replays; the step-size search and the ensemble too): "
          f"device busy {busy_us / n / 1e3:.3f} ms per draw against "
          f"{ms_per_draw:.3f} ms untraced: idle share "
          f"{1 - busy_us / n / 1e3 / ms_per_draw:.3f}; {len(kernels)} "
          f"distinct kernels")
    for e in kernels[:8]:
        print(f"[profile] {100 * e.self_device_time_total / busy_us:5.1f}% "
              f"{e.self_device_time_total / n / 1e3:8.4f} ms/draw "
              f"{e.count // n:6d} calls/draw  {e.key[:90]}")


# ---------------------------------------------------------------------------
# The operator layer (phases 27-30)
# ---------------------------------------------------------------------------

NS_STEPS = 8_000                # scripts/measure_ns_operator_tpu.py's budget
NS_BLOCK = 50
NS_NODES = 33                   # the base-fd row: 33^2 x 9
NS_LIMIT = 0.075                # mean rel L2 over the 8 held-out ICs
NS_JAX = 0.0521                 # the reference's base-fd row (TPU v5e)
# the JAX package's own tests' bounds: tests/test_fno.py:104,131 (mean rel
# error of the PINOODE family), tests/test_solvers_extra.py:86 (the
# DeepONet family), tests/test_pino_pde.py:527,466,569,684 (heat family,
# resampled IC operator, GN polish factor, DeepONetPDE)
PINO_ODE_LIMIT = 0.08
HEAT_LIMIT = 0.15
RESAMPLE_LIMIT = 0.12
GN_POLISH_FACTOR = 10.0
ENSEMBLE_RTOL = 1e-5            # member 0 against a solo solve, float32


def _operator_sum(module, params, x, cot):
    """<module(x), cot> of the module's parameters ``params``."""
    from torch.func import functional_call

    return (functional_call(module, params, (x,)) * cot).sum()


def _flat_value_grad(fn, params) -> tuple[float, float]:
    """Value and gradient norm of ``fn(params)`` in every parameter."""
    theta = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
    v = fn(theta)
    grads = torch.autograd.grad(v, list(theta.values()), allow_unused=True)
    norm = math.sqrt(sum(float(g.double().norm()) ** 2
                         for g in grads if g is not None))
    return float(v.detach()), norm


def _on(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_on(t, device) for t in tree)
    return {k: _on(v, device) for k, v in tree.items()}


def phase_operators_card_vs_cpu(card: str) -> dict:
    """The operator layer on the card against the CPU, from the same
    parameters and inputs (made once on the CPU): the spectral layers at
    odd and even sizes on random weights (their mixed spectra are not
    Hermitian), the FNOs, the DeepONets, the PINOODE loss (FNO, DeepONet),
    the NS PINOPDE loss (FD, spectral x/y, causal), and a jvp and a vjp of
    the NS residual vector."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.examples.ns_vorticity_pino import (
        make_alg as ns_alg,
    )
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.solvers import pino, pino_pde

    tj.reset_launch_counts()
    gen = torch.Generator().manual_seed(27)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    def module_case(what, module, x):
        module.reset_parameters(gen)
        params = {k: v.detach().clone() for k, v in module.named_parameters()}
        with torch.no_grad():
            cot = torch.randn(module(x).shape, generator=gen)
        vals = [_flat_value_grad(lambda th, d=d: _operator_sum(
            module, th, _on(x, d), cot.to(d)), _on(params, d))
            for d in ("cpu", "cuda")]
        _card_vs_cpu_line(what, *vals, tag="operators-card-vs-cpu")

    for n in (15, 16):
        module_case(f"SpectralConv1D T={n}",
                    npde.SpectralConv1D(4, 5, 64), randn(4, n, 3))
        module_case(f"SpectralConv2D {n}x{n - 3}",
                    npde.SpectralConv2D(3, 4, (64, 5)), randn(3, n, n - 3, 2))
        module_case(f"SpectralConv3D {n}x{n - 1}x{n - 6}",
                    npde.SpectralConv3D(2, 3, (5, 5, 64)),
                    randn(2, n, n - 1, n - 6, 2))
    grids = lambda *ns: tuple(torch.linspace(0, 1, n) for n in ns)  # noqa: E731
    module_case("FNO1D w16 m8 d3", npde.FNO1D(1, 16, 8, 3),
                (randn(1, 40), torch.linspace(0, 1, 21)[None]))
    module_case("FNO2D w16 m6 d2 field input",
                npde.FNO2D(1, width=16, modes=6, depth=2),
                (randn(1, 17, 17, 10), grids(17, 17)))
    module_case("FNO3D w16 m(8,8,4) d3",
                npde.FNO3D(1, width=16, modes=(8, 8, 4), depth=3,
                           out_channels=2),
                (randn(1, 33, 33, 9, 2), grids(33, 33, 9)))
    module_case("DeepONet w128", npde.DeepONet(npde.mlp([1, 128, 128, 128]),
                                               npde.mlp([1, 128, 128, 128])),
                (randn(1, 64), torch.rand(1, 64, generator=gen)))
    module_case("DeepONetPDE", npde.DeepONetPDE(1, 2, latent=32,
                                                branch_sizes=(32,),
                                                trunk_sizes=(32, 32)),
                (randn(1, 10), grids(17, 17)))

    prob = npde.ODEProblem(lambda u, p, t: torch.cos(p * t), 1.0, (0.0, 1.0))
    for what, chain, p, t in [
            ("PINOODE FNO1D loss", npde.FNO1D(1, 16, 8, 3),
             torch.linspace(0.1, 2, 40)[None], torch.linspace(0, 1, 21)[None]),
            ("PINOODE DeepONet loss", npde.DeepONet(
                npde.mlp([1, 128, 128, 128]), npde.mlp([1, 128, 128, 128])),
             0.1 + 1.9 * torch.rand(1, 64, generator=gen),
             torch.rand(1, 64, generator=gen))]:
        chain.reset_parameters(gen)
        params = {f"depvar.{k}": v.detach().clone()
                  for k, v in chain.named_parameters()}
        phi = pino.PINOPhi(chain)
        vals = [_flat_value_grad(lambda th, d=d: pino._losses(
            phi, prob, p.to(d), t.to(d), th), _on(params, d))
            for d in ("cpu", "cuda")]
        _card_vs_cpu_line(what, *vals, tag="operators-card-vs-cpu")

    for what, kw in [("PINOPDE NS 33^2x9, 2 members, FD", {}),
                     ("PINOPDE NS, spectral_axes=(x, y)", {"spectral": True}),
                     ("PINOPDE NS, causal_eps=1", {"causal_eps": 1.0})]:
        system, alg = ns_alg(members=2, **kw)
        built = [pino_pde._build(system, alg, d) for d in ("cpu", "cuda")]
        theta0 = built[0].theta0
        vals = [_flat_value_grad(lambda th, b=b: b.total_loss(th, None),
                                 _on(theta0, b.device)) for b in built]
        _card_vs_cpu_line(what, *vals, tag="operators-card-vs-cpu")

    # Gauss-Newton takes no additional loss: the residual rows alone
    system, alg = ns_alg(members=2, additional_loss=None)
    out = []
    for d in ("cpu", "cuda"):
        r_fn, theta0, _ = npde.build_pino_pde_residual_vector(system, alg,
                                                              device=d)
        if d == "cpu":
            g2 = torch.Generator().manual_seed(5)
            tangent = {k: torch.randn(v.shape, generator=g2)
                       for k, v in theta0.items()}
            cot = torch.randn(r_fn(theta0).shape, generator=g2)
        primal = _on({k: v.detach() for k, v in theta0.items()}, d)
        r, jv = torch.func.jvp(r_fn, (primal,), (_on(tangent, d),))
        (jtu,) = torch.func.vjp(r_fn, primal)[1](cot.to(d))
        out.append((r.cpu(), jv.cpu(),
                    torch.cat([v.reshape(-1) for v in jtu.values()]).cpu()))
    for name, a, b in zip(("residual", "jvp", "vjp"), *out):
        rel = float((b - a).abs().max() / a.abs().max())
        print(f"[operators-card-vs-cpu] NS residual vector {name}: max abs "
              f"difference {rel:.2e} of the largest entry "
              f"({a.numel()} entries; limit {CARD_VS_CPU_RTOL['grad_norm']})")
        if not rel <= CARD_VS_CPU_RTOL["grad_norm"]:
            raise AssertionError(f"NS residual {name}: card disagrees")
    counts = tj.launch_counts()
    print(f"[operators-card-vs-cpu] tanh_jet2 launches {counts} (no Taylor "
          f"jets on the operator path); {card}")
    _require_counts("operators card vs CPU", counts, False)
    return counts


def _pino_solve_line(what, sol, seconds, steps, points=None):
    g = sol.original.aux["cuda_graph"]
    rate = (f", {points * steps / seconds:.6g} points/s" if points else "")
    return (f"{what}: {steps} steps in {seconds:.2f} s ({1e3 * seconds / steps:.3f} "
            f"ms a step over the run, eager step and capture included{rate}); "
            f"{g['captures']} capture(s) in {g['capture_seconds']:.3f} s, "
            f"{g['replays']} replays")


def _mean_rel(sol, ps, ts) -> float:
    pred = sol(ps[None, :], ts[None, :]).cpu().numpy()
    want = 1.0 + np.sin(ps[None, :] * ts[:, None]) / ps[None, :]
    return float(np.mean(np.abs(pred - want) / np.abs(want)))


def phase_pino_ode(card: str) -> dict:
    """`solve_pino_ode` on the du/dt = cos(p t) family: the DeepONet at the
    reference's throughput width (w128, 256 x 256 (p, t) points a step),
    the FNO1D of tests/test_fno.py:84 and `solve_pino_gauss_newton` at
    tests/test_fno.py:118's configuration (float64, as that test runs)."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    tj.reset_launch_counts()
    prob = npde.ODEProblem(lambda u, p, t: torch.cos(p * t), 1.0, (0.0, 1.0))
    ps, ts = np.linspace(0.2, 1.9, 20), np.linspace(0.0, 1.0, 21)

    alg = npde.PINOODE(npde.DeepONet(npde.mlp([1, 128, 128, 128]),
                                     npde.mlp([1, 128, 128, 128])),
                       npde.adam(3e-3), bounds=[(0.1, 2.0)],
                       number_of_parameters=256,
                       strategy=npde.StochasticTraining(256))
    steps = 3_000
    sol, seconds, peak = _sol_seconds(lambda: npde.solve_pino_ode(
        prob, alg, maxiters=steps, inner_steps=100, abstol=0.0))
    rel = _mean_rel(sol, ps, ts)
    print(f"[pino-ode] " + _pino_solve_line(
        "DeepONet branch/trunk 1->128^3, StochasticTraining(256) x 256 "
        "parameters (65,536 points a step), Adam 3e-3, f32", sol, seconds,
        steps, 65_536) + f"; peak {peak:.3f} GiB; mean rel error "
          f"{rel:.4e} against 1 + sin(p t)/p (limit {PINO_ODE_LIMIT}); {card}")
    _require_graph("pino-ode DeepONet", sol.original, eager=1)
    if not rel < PINO_ODE_LIMIT:
        raise AssertionError(f"pino-ode DeepONet: mean rel error {rel}")

    alg = npde.PINOODE(npde.FNO1D(1, width=16, modes=8, depth=3),
                       npde.adam(5e-3), bounds=[(0.1, 2.0)],
                       number_of_parameters=40,
                       strategy=npde.GridTraining(0.05))
    sol, seconds, _ = _sol_seconds(lambda: npde.solve_pino_ode(
        prob, alg, maxiters=steps, inner_steps=25, abstol=0.0))
    rel = _mean_rel(sol, ps, ts)
    print(f"[pino-ode] " + _pino_solve_line(
        "FNO1D w16 m8 d3, GridTraining(0.05) x 40 parameters, Adam 5e-3, "
        "f32", sol, seconds, steps) + f"; mean rel error {rel:.4e} (limit "
          f"{PINO_ODE_LIMIT})")
    _require_graph("pino-ode FNO1D", sol.original, eager=1)
    if not rel < PINO_ODE_LIMIT:
        raise AssertionError(f"pino-ode FNO1D: mean rel error {rel}")

    with _default_dtype(torch.float64):
        alg = npde.PINOODE(npde.FNO1D(1, width=8, modes=6, depth=2),
                           bounds=[(0.5, 1.5)], number_of_parameters=16,
                           strategy=npde.GridTraining(0.1))
        sol, seconds, _ = _sol_seconds(lambda: npde.solve_pino_gauss_newton(
            prob, alg, maxiters=40))
        ps2, ts2 = np.linspace(0.6, 1.4, 8), np.linspace(0.0, 1.0, 11)
        rel = _mean_rel(sol, ps2, ts2)
    g = sol.original.aux["cuda_graph"]
    print(f"[pino-ode] solve_pino_gauss_newton FNO1D w8 m6 d2, 16 x 11 grid, "
          f"f64: {sol.original.iterations} outer iterations in {seconds:.2f} s, "
          f"objective {sol.original.objective:.4e}, mean rel error {rel:.4e} "
          f"(limit {PINO_ODE_LIMIT}); inner graphs {g}")
    if not rel < PINO_ODE_LIMIT:
        raise AssertionError(f"pino-ode GN: mean rel error {rel}")
    counts = tj.launch_counts()
    print(f"[pino-ode] tanh_jet2 launches {counts}")
    _require_counts("pino-ode", counts, False)
    return counts


def _ns_share(prof, steps: int) -> None:
    """The NS step's device time by operator, from eager steps (a replayed
    graph's kernels carry no operator): the complex mixing GEMMs
    (`aten::bmm`, forward and backward: the only batched GEMMs of the
    step), the einsums' own copies, cuFFT, the pointwise real GEMMs."""
    from torch.autograd import DeviceType

    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    total = sum(e.self_device_time_total for e in ops)

    def share(pred):
        return sum(e.self_device_time_total for e in ops if pred(e.key))

    groups = {
        "complex mixing GEMMs (aten::bmm)": share(lambda k: k == "aten::bmm"),
        "cuFFT (aten::_fft_*)": share(lambda k: k.startswith("aten::_fft")),
        "pointwise real GEMMs (aten::mm/addmm)": share(
            lambda k: k in ("aten::mm", "aten::addmm")),
        "copies (aten::copy_/clone/cat)": share(
            lambda k: k in ("aten::copy_", "aten::clone", "aten::cat")),
    }
    einsum = sum(e.device_time_total for e in ops if e.key == "aten::einsum")
    rest = total - sum(groups.values())
    print(f"[profile] NS step by operator over {steps} eager steps: device "
          f"{total / steps / 1e3:.3f} ms a step; " + "; ".join(
              f"{k} {100 * v / total:.1f}%" for k, v in groups.items())
          + f"; everything else (elementwise, FD stencils, reductions, "
          f"Adam) {100 * rest / total:.1f}%; the forward einsums with their "
          f"permute copies {100 * einsum / total:.1f}%")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile] {100 * e.self_device_time_total / total:5.1f}% "
              f"{e.self_device_time_total / steps / 1e3:8.4f} ms/step "
              f"{e.count // steps:6d} calls/step  {e.key[:80]}")


def _ns_tf32_check(card: str) -> None:
    """Whether `allow_tf32` changes the complex mixing einsum (cgemm) at
    the NS shapes: the same einsum with the flag off and on."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    xf = torch.randn((16, 8, 8, 4, 12), dtype=torch.complex64,
                     generator=gen, device="cuda")
    w = torch.randn((8, 8, 4, 16, 16), dtype=torch.complex64, generator=gen,
                    device="cuda")
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        out = {}
        for tf32 in (False, True):
            flags.allow_tf32 = tf32
            out[tf32] = torch.einsum("ixyzp,xyzio->oxyzp", xf, w)
            ms = _event_ms(lambda: torch.einsum("ixyzp,xyzio->oxyzp", xf, w))
            out[f"ms{tf32}"] = ms
        diff = float((out[True] - out[False]).abs().max()
                     / out[False].abs().max())
    finally:
        flags.allow_tf32 = before
    print(f"[pino-pde] the complex mixing einsum at the NS shapes "
          f"(16 x 8x8x4 x 12 by 8x8x4 x 16 x 16, complex64): TF32 on against "
          f"off, max difference {diff:.2e} of the largest entry; "
          f"{out['msFalse'] * 1e3:.1f} us off, {out['msTrue'] * 1e3:.1f} us "
          f"on; {card}")


def phase_pino_pde(card: str) -> dict:
    """The slice's main path: the NS vorticity operator of the base-fd row
    (FNO3D w16 m(8,8,4) d3, 33^2 x 9 grid, 12 GRF ICs, Adam 2e-3, 8,000
    steps in blocks of 50, float32, TF32 off) scored on the 8 held-out ICs;
    a traced window of replayed steps and the per-operator shares; then the
    JAX tests' heat family, resampled IC operator, Gauss-Newton polish and
    DeepONetPDE family."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch import accuracy
    from neuralpde_tpu_torch.compile.lower import depvar_params
    from neuralpde_tpu_torch.examples.ns_vorticity_pino import (
        make_alg as ns_alg,
    )
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.solvers import pino_pde
    from neuralpde_tpu_torch.solvers.ode import _SimpleProblem

    tj.reset_launch_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    system, alg = ns_alg()
    stamps = []

    def stamp(it, loss, aux):
        stamps.append((it, time.perf_counter(), loss))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = npde.solve_pino_pde(system, alg, maxiters=NS_STEPS,
                              inner_steps=NS_BLOCK, callback=stamp,
                              abstol=0.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = stamps[-1][0] - stamps[0][0]
    step_s = (stamps[-1][1] - stamps[0][1]) / steps
    mean, rels = accuracy.ns_rel_l2(sol, NS_NODES)
    g = sol.original.aux["cuda_graph"]
    print(f"[pino-pde] NS vorticity base-fd: FNO3D w16 m(8,8,4) d3 out 2, "
          f"33^2 x 9 grid, 12 GRF ICs (l 0.25, sigma 3), gauge loss, Adam "
          f"2e-3, f32 TF32 off: {NS_STEPS} steps in {seconds:.2f} s; first "
          f"block (eager step, capture, {NS_BLOCK - 2} replays) "
          f"{stamps[0][1] - t0:.3f} s; then {1e3 * step_s:.3f} ms a step, "
          f"{1 / step_s:.1f} steps/s; {g['captures']} capture(s) in "
          f"{g['capture_seconds']:.3f} s, {g['replays']} replays; peak "
          f"{peak:.3f} GiB; loss {stamps[0][2]:.4e} -> {stamps[-1][2]:.4e}; "
          f"cuFFT plan cache {torch.backends.cuda.cufft_plan_cache.size} of "
          f"{torch.backends.cuda.cufft_plan_cache.max_size}; {card}")
    print(f"[pino-pde] NS mean rel L2 of the vorticity over the 8 held-out "
          f"ICs (key 4242, 65^2 -> 33^2 spectrally), against the spectral "
          f"solver at n=128: {mean:.4f} (per IC "
          f"{[round(r, 4) for r in rels]}; limit {NS_LIMIT}; the JAX "
          f"package's TPU row {NS_JAX})")
    _require_graph("NS solve", sol.original, eager=1)
    _require_falling("NS solve", [s[2] for s in stamps[::10]] + [stamps[-1][2]])
    if not mean < NS_LIMIT:
        raise AssertionError(f"NS operator: mean rel L2 {mean} >= {NS_LIMIT}")

    # a traced window of replayed steps, then eager steps by operator
    b = pino_pde._build(system, alg)
    bare = _SimpleProblem(b.total_loss, sol.original.u)
    _profile_solve(bare, npde.adam(2e-3), 22, 22, step_s)
    step = npde.make_step(bare.loss, npde.adam(2e-3))
    ones = {k: torch.ones(n, device="cuda") for k, n in
            (("pde_weights", 0), ("bc_weights", 0), ("additional_weights", 1))}
    carry = step.init(sol.original.u, ones)
    generator = torch.Generator(device="cuda").manual_seed(0)
    carry, _ = step(carry, generator)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            carry, _ = step(carry, generator)
        torch.cuda.synchronize()
    _ns_share(prof, 5)
    _ns_tf32_check(card)

    # the JAX tests' families beside the NS run
    heat = accuracy.heat_family_system()
    ps = np.linspace(0.1, 0.45, 7)
    alg = npde.PINOPDE(chain=npde.FNO2D(1, width=16, modes=6, depth=2),
                       opt=npde.adam(3e-3), bounds=[(0.05, 0.5)],
                       number_of_parameters=10,
                       strategy=npde.GridTraining(1 / 16))
    sol, seconds, _ = _sol_seconds(lambda: npde.solve_pino_pde(
        heat, alg, maxiters=800, inner_steps=25, abstol=0.0))
    rel = accuracy.heat_family_rel_l2(sol, ps)
    print("[pino-pde] " + _pino_solve_line(
        "heat family FNO2D w16 m6 d2, 17^2 grid x 10, Adam 3e-3, f32",
        sol, seconds, 800) + f"; rel L2 on the 33^2 grid at 7 parameters off "
          f"the training set {rel:.4e} (limit {HEAT_LIMIT})")
    _require_graph("heat family", sol.original, eager=1)
    if not rel < HEAT_LIMIT:
        raise AssertionError(f"heat family: rel L2 {rel}")

    x, t = npde.symbols("x t")
    u, f0 = npde.DepVar("u"), npde.DepVar("f0")
    nu = 0.05
    ic_sys = npde.PDESystem(
        npde.Eq(npde.Differential(t)(u(x, t)),
                nu * (npde.Differential(x) ** 2)(u(x, t))),
        [npde.Eq(u(x, 0.0), f0(x)), npde.Eq(u(0.0, t), u(1.0, t))],
        [npde.Domain(x, npde.Interval(0, 1)),
         npde.Domain(t, npde.Interval(0, 0.5))], ivs=[x, t], dvs=[u(x, t)])
    grf = npde.GaussianRandomField(length_scale=0.15)
    alg = npde.PINOPDE(chain=npde.FNO2D(1, width=16, modes=(10, 6), depth=2),
                       opt=npde.adam(2e-3), number_of_parameters=16,
                       input_functions={f0(x): grf}, resample=True,
                       strategy=npde.GridTraining([1 / 32, 1 / 16]))
    sol, seconds, _ = _sol_seconds(lambda: npde.solve_pino_pde(
        ic_sys, alg, maxiters=800, inner_steps=25, abstol=0.0))
    gx = sol.grids[0].cpu().numpy().astype(np.float64)
    gt = sol.grids[1].cpu().numpy().astype(np.float64)
    test_ic = grf(torch.Generator().manual_seed(77), [gx], 8).double().numpy()
    pred = sol(input_values={"f0": test_ic}).cpu().numpy()
    m = len(gx) - 1
    k = 2 * np.pi * np.fft.rfftfreq(m, d=1.0 / m)
    uh0 = np.fft.rfft(test_ic[:-1, :], axis=0)
    want = np.stack([np.fft.irfft(uh0 * np.exp(-nu * k[:, None] ** 2 * tt),
                                  n=m, axis=0) for tt in gt], axis=1)
    want = np.concatenate([want, want[:1]], axis=0)
    rel = float(np.linalg.norm(pred - want) / np.linalg.norm(want))
    print("[pino-pde] " + _pino_solve_line(
        "resample=True heat IC operator FNO2D w16 m(10,6) d2, a new GRF "
        "family of 16 (l 0.15) drawn inside every replay", sol, seconds, 800)
          + f"; rel L2 on 8 held-out ICs against the exact evolution "
          f"{rel:.4e} (limit {RESAMPLE_LIMIT})")
    _require_graph("resampled family", sol.original, eager=1)
    if not rel < RESAMPLE_LIMIT:
        raise AssertionError(f"resampled family: rel L2 {rel}")

    with _default_dtype(torch.float64):
        mk = lambda **kw: npde.PINOPDE(  # noqa: E731
            chain=npde.FNO2D(1, width=16, modes=6, depth=2),
            opt=npde.adam(3e-3), bounds=[(0.05, 0.5)],
            number_of_parameters=10, strategy=npde.GridTraining(1 / 16), **kw)
        sol = npde.solve_pino_pde(heat, mk(), maxiters=400, inner_steps=25,
                                  abstol=0.0)
        adam_loss = sol.original.objective
        sol2, seconds, _ = _sol_seconds(lambda: npde.solve_pino_pde_gauss_newton(
            heat, mk(init_params=depvar_params(sol.original.u)), maxiters=30))
    gn_loss = sol2.original.objective
    print(f"[pino-pde] Gauss-Newton polish of the heat family (f64, as the "
          f"JAX test runs): Adam 400 steps {adam_loss:.4e} -> 30 LM "
          f"iterations {gn_loss:.4e} ({adam_loss / gn_loss:.1f}x, limit "
          f"{GN_POLISH_FACTOR}x) in {seconds:.2f} s; inner graphs "
          f"{sol2.original.aux['cuda_graph']}")
    if not gn_loss < adam_loss / GN_POLISH_FACTOR:
        raise AssertionError("GN polish: the loss fell less than 10x")

    alg = npde.PINOPDE(chain=npde.DeepONetPDE(1, 2, latent=32,
                                              branch_sizes=(32,),
                                              trunk_sizes=(32, 32)),
                       opt=npde.adam(3e-3), bounds=[(0.05, 0.5)],
                       number_of_parameters=10,
                       strategy=npde.GridTraining(1 / 16))
    sol, seconds, _ = _sol_seconds(lambda: npde.solve_pino_pde(
        heat, alg, maxiters=800, inner_steps=25, abstol=0.0))
    gx = 0.5 * (1 - np.cos(np.linspace(0, np.pi, 29)))
    gt = np.sort(np.concatenate([[0.0, 1.0], np.random.default_rng(0)
                                 .uniform(0, 1, 21)]))
    pred = sol(p=ps[None, :], grids=[gx, gt]).cpu().numpy()
    want = (np.exp(-ps[None, None, :] * np.pi**2 * gt[None, :, None])
            * np.sin(np.pi * gx[:, None, None]))
    rel = float(np.linalg.norm(pred - want) / np.linalg.norm(want))
    print("[pino-pde] " + _pino_solve_line(
        "DeepONetPDE heat family (latent 32)", sol, seconds, 800)
          + f"; rel L2 on a non-uniform grid {rel:.4e} (limit {HEAT_LIMIT})")
    if not rel < HEAT_LIMIT:
        raise AssertionError(f"DeepONetPDE family: rel L2 {rel}")
    counts = tj.launch_counts()
    print(f"[pino-pde] tanh_jet2 launches {counts}")
    _require_counts("pino-pde", counts, False)
    return counts


def _ms_per_step(run, steps: int, block: int) -> tuple[float, object]:
    """ms a replayed step of ``run(callback)`` over the blocks after the
    first (eager step and capture)."""
    stamps = []

    def stamp(it, *_):
        torch.cuda.synchronize()
        stamps.append((it, time.perf_counter()))

    res = run(stamp)
    n = stamps[-1][0] - stamps[0][0]
    return 1e3 * (stamps[-1][1] - stamps[0][1]) / n, res


def phase_ensembles(card: str) -> dict:
    """`solve_pino_pde_ensemble(n_ensemble=8)` on the heat family against
    solo solves (member 0 from the same parameters, ms a step), and
    `solve_ensemble(n_ensemble=8)` on scripts/measure_ensemble_tpu.py's 2-D
    Poisson (mlp([2,64,64,1]), GridTraining(1/63)) against a solo solve."""
    import dataclasses

    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch import accuracy
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    tj.reset_launch_counts()
    heat = accuracy.heat_family_system()
    alg = npde.PINOPDE(chain=npde.FNO2D(1, width=16, modes=6, depth=2),
                       opt=npde.adam(3e-3), bounds=[(0.05, 0.5)],
                       number_of_parameters=10,
                       strategy=npde.GridTraining(1 / 16))
    steps, block = 200, 25
    ens_ms, ens = _ms_per_step(lambda cb: npde.solve_pino_pde_ensemble(
        heat, alg, n_ensemble=8, maxiters=steps, inner_steps=block, seed=3,
        callback=cb), steps, block)
    gen = torch.Generator().manual_seed(3)
    alg.chain.reset_parameters(gen)
    init = {k: v.detach().clone() for k, v in alg.chain.named_parameters()}
    solo_ms, solo = _ms_per_step(lambda cb: npde.solve_pino_pde(
        heat, dataclasses.replace(alg, init_params=init), maxiters=steps,
        inner_steps=block, callback=cb, abstol=0.0), steps, block)
    member = ens.member_solution(0)
    d_u = float((member.u - solo.u).abs().max() / solo.u.abs().max())
    d_loss = abs(float(ens.losses[0]) - solo.original.objective) / \
        abs(solo.original.objective)
    mean, std = ens.mean_and_std()
    print(f"[ensembles] solve_pino_pde_ensemble(n_ensemble=8) heat family "
          f"FNO2D w16 m6 d2: {ens_ms:.3f} ms a step against {solo_ms:.3f} ms "
          f"solo ({ens_ms / solo_ms:.2f}x for 8 members; "
          f"{8e3 / ens_ms:.1f} against {1e3 / solo_ms:.1f} member-steps/s); "
          f"losses {[f'{v:.3e}' for v in ens.losses.tolist()]}, best "
          f"{ens.best_index} with u {tuple(ens.best.u.shape)}, mean/std "
          f"{tuple(mean.shape)}/{tuple(std.shape)}; member 0 against a solo "
          f"solve from its parameters after {steps} steps: fields {d_u:.2e}, "
          f"loss {d_loss:.2e} (limit {ENSEMBLE_RTOL}); graphs "
          f"{ens.aux['cuda_graph']}; {card}")
    if not (d_u <= ENSEMBLE_RTOL and d_loss <= ENSEMBLE_RTOL):
        raise AssertionError("ensemble member 0 differs from the solo solve")
    if tuple(mean.shape) != tuple(solo.u.shape) or not bool(
            torch.isfinite(std).all()):
        raise AssertionError("ensemble mean_and_std: wrong shape or values")

    system = accuracy.poisson_2d_system()
    prob = npde.discretize(system, npde.PhysicsInformedNN(
        npde.mlp([2, 64, 64, 1]), npde.GridTraining(1 / 63),
        dtype=torch.float32, device="cuda"))
    steps, block = 600, 100
    ens_ms, ens = _ms_per_step(lambda cb: npde.solve_ensemble(
        prob, npde.adam(1e-3), maxiters=steps, n_ensemble=8,
        inner_steps=block, callback=cb), steps, block)
    _TRAINED["ensemble"] = ens
    solo_ms, solo = _ms_per_step(lambda cb: npde.solve(
        prob, npde.adam(1e-3), maxiters=steps, inner_steps=block,
        callback=cb), steps, block)
    print(f"[ensembles] solve_ensemble(n_ensemble=8) 2-D Poisson "
          f"mlp([2,64,64,1]) GridTraining(1/63), jvp, f32: {ens_ms:.3f} ms a "
          f"step against {solo_ms:.3f} ms solo: {8e3 / ens_ms:.1f} "
          f"member-steps/s against {1e3 / solo_ms:.1f} for one solo solve "
          f"(eight solo solves: the same rate, one after another); "
          f"per-member efficiency {8 * solo_ms / ens_ms:.2f}; losses "
          f"{[f'{v:.3e}' for v in ens.losses.tolist()]}; graphs "
          f"{ens.aux['cuda_graph']}")
    if not bool(torch.isfinite(ens.losses).all()):
        raise AssertionError("Poisson ensemble: non-finite losses")
    counts = tj.launch_counts()
    print(f"[ensembles] tanh_jet2 launches {counts}")
    _require_counts("ensembles", counts, False)
    return counts


SCALE_STEPS = 200           # phase 31: the solve under the mesh and without
SCALE_BLOCK = 20
SCALE_FIRST_RTOL = 1e-6     # first step's loss and gradient norm
SCALE_FINAL_RTOL = 1e-4     # loss after SCALE_STEPS steps
SCALE_RANK_STEPS = 60       # each rank's steps where the host has >= 2 cards
SCALE_TURN_REPLAYS = 5      # replays a turn, timing the collective's cost
EXPORT_POINTS = 2 ** 20     # phase 32: the exported phi's batch
EXPORT_ABS = 1e-6           # its max abs difference from phi, f32, no TF32
EXPORT_PINO_RTOL = 1e-5     # the exported NS operator against sol()
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
# phase 30's ensemble-8, which phase 31 runs again under the mesh, and
# phase 31's trained phi and parameters, which phase 32 exports
_TRAINED: dict = {}


def _file_store(name: str) -> str:
    """A fresh file store for a process group, under build/."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"{name}.store")
    if os.path.exists(path):
        os.remove(path)
    return path


def _nccl_kernels(runner, start: int, n: int) -> int:
    """Kernels with "nccl" in their names that a trace of ``n`` replays of
    a warmed `GraphedSteps` shows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(start, start + n):
            runner(i)
        torch.cuda.synchronize()
    return sum(e.count for e in _device_events(prof)
               if "nccl" in e.key.lower())


def _runner(prob):
    """A `GraphedSteps` over a `make_step` of ``prob`` (``mesh_shares``)."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.train import GraphedSteps

    rep = prob.pinnrep
    lf = rep.loss_functions
    step = npde.make_step(prob.loss, npde.adam(1e-3), rep.adaloss,
                          lf.pde_loss_functions, lf.bc_loss_functions,
                          matmul_precision=rep.matmul_precision,
                          mesh_shares=True)
    carry = step.init(prob.init_params,
                      rep.adaloss.init_state(1, 4, rep.dtype, "cuda"))
    return GraphedSteps(step, carry,
                        torch.Generator(device="cuda").manual_seed(0))


def _replay_ms(runner, n: int) -> float:
    """ms a replay of a warmed `GraphedSteps` over ``n`` replays."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, 2 + n):
        runner(i)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def _scale_solve(prob, mesh, steps: int, block: int):
    """``solve`` of ``prob`` for ``steps`` steps under ``mesh`` (or none)
    -> (result, ms a replayed step after the first block)."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.parallel.mesh import use_mesh

    def run(stamp):
        with (use_mesh(mesh) if mesh is not None
              else contextlib.nullcontext()):
            return npde.solve(prob, npde.adam(1e-3), maxiters=steps,
                              inner_steps=block, callback=stamp,
                              generator=torch.Generator(
                                  device="cuda").manual_seed(5))

    ms, res = _ms_per_step(run, steps, block)
    return res, ms


def scale_out_rank(rank: int, world: int, store: str) -> None:
    """One rank of phase 31's multi-card run: bench's dense headline under
    a mesh of ``world`` cards for SCALE_RANK_STEPS steps; rank 0 prints one
    JSON line with its ms a step."""
    import torch.distributed as dist

    from bench_torch import poisson_problem
    from neuralpde_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from neuralpde_tpu_torch.parallel.mesh import make_mesh

    initialize_distributed(f"file://{store}", world, rank)
    try:
        mesh = make_mesh()
        prob = poisson_problem(BATCH, microbatch=MICROBATCH)
        res, ms = _scale_solve(prob, mesh, SCALE_RANK_STEPS, SCALE_BLOCK)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ms": ms, "loss": res.objective,
                          "graphs": res.aux["cuda_graph"]}), flush=True)


def _multi_card(card: str, world: int, ms_one: float) -> None:
    """Phase 31 over ``world`` cards, one process each: the same global
    batch, ms a step against one card's."""
    store = _file_store("phase31-multi")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; c.scale_out_rank("
         f"{r}, {world}, {store!r})"], cwd=root,
        env={**os.environ, "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"scale-out rank failed: {out[-3000:]}")
    got = json.loads([ln for ln in outs[0].splitlines()
                      if ln.startswith("{")][-1])
    print(f"[scale-out] {world} cards, one process each, global batch "
          f"{BATCH}: {got['ms']:.3f} ms a step against {ms_one:.3f} ms on "
          f"one card under the mesh: speed-up {ms_one / got['ms']:.3f} "
          f"(ideal {world}); loss after {SCALE_RANK_STEPS} steps "
          f"{got['loss']:.6g}; graphs {got['graphs']}; {card}")


def phase_scale_out(card: str) -> dict:
    """Scale-out on the card: one rank of an NCCL process group
    (`initialize_distributed`), bench's dense headline through `solve`
    under `use_mesh(make_mesh())` with the gradient all-reduce captured in
    the step's graph, against the same solve without a mesh; then
    `solve_ensemble(mesh=)` on ensemble-8 and `sample_chains(mesh=)` on
    phase 26's Gaussian against their runs without a mesh."""
    import torch.distributed as dist

    import neuralpde_tpu_torch as npde
    from bench_torch import poisson_problem
    from neuralpde_tpu_torch import accuracy
    from neuralpde_tpu_torch.bayesian import hmc
    from neuralpde_tpu_torch.compile.lower import depvar_params
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from neuralpde_tpu_torch.parallel.mesh import make_mesh, no_mesh, use_mesh
    from neuralpde_tpu_torch.train import _side_stream

    store = _file_store("phase31")
    initialize_distributed(f"file://{store}", 1, 0)
    try:
        mesh = make_mesh()
        print(f"[scale-out] NCCL process group of {dist.get_world_size()} "
              f"rank(s), mesh {mesh.shape} on {mesh.device}")
        prob = poisson_problem(BATCH, microbatch=MICROBATCH)

        # the first step (eager), the capture, then replays in turns
        # without, under, under and without the mesh: the collective's cost
        runners = {False: _runner(prob), True: _runner(prob)}
        like = next(iter(runners[False].theta.values()))
        first, ms = {}, {False: [], True: []}
        with use_mesh(mesh), _side_stream(like):
            for meshed in (False, True):
                with (contextlib.nullcontext() if meshed else no_mesh()):
                    loss, _ = runners[meshed](0)
                    first[meshed] = (float(loss), math.sqrt(sum(
                        float((v.grad.double() ** 2).sum())
                        for v in runners[meshed].theta.values())))
                    runners[meshed](1)
            for meshed in (False, True, True, False):
                with (contextlib.nullcontext() if meshed else no_mesh()):
                    ms[meshed].append(_replay_ms(runners[meshed],
                                                 SCALE_TURN_REPLAYS))
            nccl = _nccl_kernels(runners[True], 2, 3)
        del runners, like
        (l0, n0), (l1, n1) = first[False], first[True]
        d_first = max(abs(l1 - l0) / abs(l0), abs(n1 - n0) / abs(n0))
        print(f"[scale-out] first step, no mesh vs mesh: loss {l0:.9g} vs "
              f"{l1:.9g}, grad norm {n0:.9g} vs {n1:.9g} (the summed "
              f"gradient): rel {d_first:.3e} (limit {SCALE_FIRST_RTOL})")
        print(f"[scale-out] a replay of the captured step, in turns without, "
              f"under, under, without the mesh: {ms[False][0]:.3f}, "
              f"{ms[True][0]:.3f}, {ms[True][1]:.3f}, {ms[False][1]:.3f} ms "
              f"({SCALE_TURN_REPLAYS} replays each): the collective's cost "
              f"{np.mean(ms[True]) - np.mean(ms[False]):+.3f} ms a step; a "
              f"trace of 3 replays under the mesh shows {nccl} NCCL kernel "
              f"launch(es)")
        if not d_first <= SCALE_FIRST_RTOL:
            raise AssertionError("scale-out: the first step under the mesh "
                                 "differs from the step without it")

        plain, ms_plain = _scale_solve(prob, None, SCALE_STEPS, SCALE_BLOCK)
        tj.reset_launch_counts()
        meshed, ms_mesh = _scale_solve(prob, mesh, SCALE_STEPS, SCALE_BLOCK)
        counts = tj.launch_counts()
        d_final = abs(meshed.objective - plain.objective) / abs(
            plain.objective)
        points = BATCH + 4 * (BATCH // 8)
        print(f"[scale-out] dense-poisson-w64 (batch {BATCH}, microbatch "
              f"{MICROBATCH}, jet, Adam 1e-3, f32, TF32 off) through solve("
              f"inner_steps={SCALE_BLOCK}), {SCALE_STEPS} steps: without a "
              f"mesh {ms_plain:.3f} ms a step, under the mesh {ms_mesh:.3f} "
              f"ms a step (the collective's cost {ms_mesh - ms_plain:+.3f} "
              f"ms, {points / ms_mesh * 1e3:.6g} points/s); loss after "
              f"{SCALE_STEPS} {plain.objective:.9g} vs {meshed.objective:.9g}"
              f": rel {d_final:.3e} (limit {SCALE_FINAL_RTOL}); graphs "
              f"without {plain.aux['cuda_graph']}, under the mesh "
              f"{meshed.aux['cuda_graph']}; launches under the mesh (eager "
              f"step and capture) {counts}; {card}")
        if not d_final <= SCALE_FINAL_RTOL:
            raise AssertionError("scale-out: the solve under the mesh "
                                 "differs from the solve without it")
        if not meshed.aux["cuda_graph"]["replays"] > 0:
            raise AssertionError("scale-out: no replayed step under the mesh")
        _require_launched("scale-out", counts, "tanh_jet2_forward",
                          "tanh_jet2_backward")
        _TRAINED.update(phi=prob.pinnrep.phi,
                        params=depvar_params(meshed.u))

        system = accuracy.poisson_2d_system()
        eprob = npde.discretize(system, npde.PhysicsInformedNN(
            npde.mlp([2, 64, 64, 1]), npde.GridTraining(1 / 63),
            dtype=torch.float32, device="cuda"))
        t0 = time.perf_counter()
        ens_mesh = npde.solve_ensemble(eprob, npde.adam(1e-3), maxiters=600,
                                       n_ensemble=8, inner_steps=100,
                                       mesh=mesh)
        s_mesh = time.perf_counter() - t0
        # phase 30 ran it without a mesh
        ens = _TRAINED.get("ensemble") or npde.solve_ensemble(
            eprob, npde.adam(1e-3), maxiters=600, n_ensemble=8,
            inner_steps=100)
        same = (all(torch.equal(ens_mesh.members[k], v)
                    for k, v in ens.members.items())
                and torch.equal(ens_mesh.losses, ens.losses))
        print(f"[scale-out] ensemble-8 (600 steps) under the mesh in "
              f"{s_mesh:.2f} s: members and losses bit-equal to the run "
              f"without a mesh {same}; graphs {ens_mesh.aux['cuda_graph']}")
        if not same:
            raise AssertionError("scale-out: the ensemble under the mesh "
                                 "differs from the run without it")

        mu = torch.tensor([1.0, -2.0], device="cuda")
        sigma = torch.tensor([0.5, 2.0], device="cuda")

        def logdensity(q):
            return -0.5 * torch.sum(((q - mu) / sigma) ** 2)

        q0s = 0.1 * torch.arange(4.0, device="cuda")[:, None].repeat(1, 2)
        t0 = time.perf_counter()
        chains_mesh = hmc.sample_chains(logdensity, q0s, seed=0,
                                        draw_samples=1000, n_leapfrog=20,
                                        mesh=mesh)
        s_chains = time.perf_counter() - t0
        chains = hmc.sample_chains(logdensity, q0s, seed=0,
                                   draw_samples=1000, n_leapfrog=20)
        same = torch.equal(chains_mesh, chains)
        print(f"[scale-out] sample_chains: 4 HMC chains x 1000 draws of phase "
              f"26's Gaussian under the mesh in {s_chains:.2f} s: draws "
              f"bit-equal to the run without a mesh {same}")
        if not same:
            raise AssertionError("scale-out: the chains under the mesh "
                                 "differ from the run without it")
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    n = torch.cuda.device_count()
    if n >= 2:
        _multi_card(card, min(n, 4), ms_mesh)
    else:
        print(f"[scale-out] {n} card: multi-rank runs were not made (they "
              "need one card a rank)")
    return counts


def phase_export(card: str) -> dict:
    """Export of phase 31's trained phi (dynamic batch), loaded in a fresh
    process that imports only torch and evaluated at 2^20 points on the
    card against phi; export of the NS vorticity operator of phase 29's
    width against ``sol()``; us a call, exported against eager."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.examples.ns_vorticity_pino import (
        make_alg as ns_alg,
    )
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.utils.export import export_phi, save_exported

    tj.reset_launch_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    phi, params = _TRAINED["phi"], _TRAINED["params"]
    t0 = time.perf_counter()
    blob, call = export_phi(phi, params, 2, dtype=torch.float32)
    s_export = time.perf_counter() - t0
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "phase32_phi.pt2")
    cord_path = os.path.join(BUILD_DIR, "phase32_cord.npy")
    out_path = os.path.join(BUILD_DIR, "phase32_out.npy")
    save_exported(path, blob)
    cord = torch.rand((2, EXPORT_POINTS), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(3))
    np.save(cord_path, cord.cpu().numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "extra = {'matmul_precision': ''}\n"
        f"ep = torch.export.load({path!r}, extra_files=extra)\n"
        "torch.backends.cuda.matmul.allow_tf32 = "
        "extra['matmul_precision'] in ('high', 'default')\n"
        f"c = torch.as_tensor(np.load({cord_path!r})).cuda()\n"
        f"np.save({out_path!r}, ep.module()(c).cpu().numpy())\n"
        "assert 'neuralpde_tpu_torch' not in sys.modules\n"
        "print(extra['matmul_precision'])\n")
    # the fresh process runs while this one exports the operator
    t_fresh = time.perf_counter()
    fresh = subprocess.Popen([sys.executable, "-c", code], cwd=BUILD_DIR,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        with torch.no_grad():
            want = phi(cord, params)
        us_exported = 1e3 * _event_ms(lambda: call(cord), 20)
        us_eager = 1e3 * _event_ms(lambda: phi(cord, params), 20)
        system, alg = ns_alg()
        sol = npde.solve_pino_pde(system, alg, maxiters=25, inner_steps=25,
                                  abstol=0.0)
        ns = _export_ns(sol)
        stdout, stderr = fresh.communicate(timeout=300)
    finally:
        if fresh.poll() is None:
            fresh.kill()
    s_fresh = time.perf_counter() - t_fresh
    if fresh.returncode != 0:
        raise AssertionError(f"export: the fresh process failed: "
                             f"{stderr[-3000:]}")
    got = torch.as_tensor(np.load(out_path), device="cuda")
    err = float((got - want).abs().max())
    print(f"[export] phase 31's phi (mlp([2,64,64,1]), f32) with a dynamic "
          f"batch: exported in {s_export:.2f} s, {len(blob)} bytes; loaded in "
          f"a fresh process that imports only torch ({s_fresh:.2f} s, beside "
          f"the operator's export; precision {stdout.strip()!r}), at "
          f"{EXPORT_POINTS} points on the card: max abs difference from phi "
          f"{err:.3e} (limit {EXPORT_ABS}); {us_exported:.1f} us a call "
          f"exported against {us_eager:.1f} us eager; {card}")
    if not err <= EXPORT_ABS:
        raise AssertionError("export: the loaded phi differs from phi")
    print(ns["line"])
    if not ns["rel"] <= EXPORT_PINO_RTOL:
        raise AssertionError("export: the exported operator differs")
    counts = tj.launch_counts()
    _require_counts("export", counts, False)
    return counts


def _export_ns(sol) -> dict:
    """Export of a trained NS operator against ``sol()``."""
    from neuralpde_tpu_torch.utils.export import export_pino_pde

    t0 = time.perf_counter()
    blob, call = export_pino_pde(sol)
    s_export = time.perf_counter() - t0
    names = sorted(sol.input_samples)
    inputs = [sol.p] + [sol.input_samples[n] for n in names]
    with torch.no_grad():
        want = sol()
        got = call(*inputs)
    rel = float((got - want).abs().max() / want.abs().max())
    us_exported = 1e3 * _event_ms(lambda: call(*inputs), 20)
    us_eager = 1e3 * _event_ms(lambda: sol(), 20)
    return {"rel": rel, "line": (
        f"[export] NS vorticity operator (FNO3D w16 m(8,8,4) d3 out 2, 33^2 "
        f"x 9 grid, 12 members, 25 steps) with a dynamic family: exported in "
        f"{s_export:.2f} s, {len(blob)} bytes; against sol(): rel "
        f"{rel:.3e} (limit {EXPORT_PINO_RTOL}); {us_exported:.1f} us a call "
        f"exported against {us_eager:.1f} us eager")}


# --- the example programs (phases 33-34) -----------------------------------

BELTRAMI_NODES = 65         # examples/beltrami_spinn.py: 65^4 grid, rank 64
BELTRAMI_RANK = 64
BELTRAMI_STEPS = 300        # of the eps = 1 stage's 20,000
BELTRAMI_BLOCK = 25
BELTRAMI_PROFILE_STEPS = 3
# the tests' size (tests/test_torch_examples.py) for the card-vs-CPU checks
SMALL_SEPARABLE = dict(rank=4, hidden=8)
HELMHOLTZ_LIMIT = 1e-2      # twice the JAX example's 5.2e-3 (TPU v5e, default
                            # precision; 3.7e-3 at "highest")
HELMHOLTZ_JAX = (5.2e-3, 3.7e-3)
TG_SPINN_STEPS = 1_000      # of the example's 2 x 20,000
TG_SPINN_BLOCK = 250
TG_DENSE_STEPS = 2_000      # of examples/taylor_green_ns.py's 2 x 20,000
TG_DENSE_BLOCK = 250
# examples/kuramoto_sivashinsky.py run by the JAX package on a CPU prints
# "relative L2 0.002" (1.968533e-03 unrounded; the port's run on a CPU
# with torch.optim.LBFGS as its L-BFGS: 6.950e-04; on the card with
# optax's rule: 7.6383e-04)
KS_LIMIT = 2e-3


def phase_beltrami(card: str) -> dict:
    """examples/beltrami_spinn.py: card against CPU at the tests' size, then
    the 65^4 grid at rank 64 through `solve`'s captured graph for
    BELTRAMI_STEPS of the eps = 1 stage, with a profile of replays."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.examples import beltrami_spinn as ex
    from neuralpde_tpu_torch.train import GraphedSteps, _side_stream

    print(f"[beltrami] torch.backends.opt_einsum.is_available() = "
          f"{torch.backends.opt_einsum.is_available()} (the contraction "
          f"order of the four-operand einsum follows it)")
    for eps in (1.0, 30.0):
        _card_vs_cpu_problem(
            f"Beltrami (5,4,4,3) nodes rank 4 hidden 8, 4 equations, 22 "
            f"conditions, causal eps {eps}, f32 highest",
            lambda device, init, eps=eps: ex.make_problem(
                ex.make_nets(dtype=torch.float32, **SMALL_SEPARABLE), eps,
                nodes=(5, 4, 4, 3), device=device, init_params=init),
            "beltrami-card-vs-cpu")

    torch.backends.cuda.matmul.allow_tf32 = False
    nets = ex.make_nets(BELTRAMI_RANK)
    prob = ex.make_problem(nets, ex.DEFAULT_STAGES[0][0],
                           nodes=BELTRAMI_NODES)
    lr = ex.DEFAULT_STAGES[0][1]
    res, seconds, ms, counts, peak = _timed_solve(
        prob, npde.adam(lr), BELTRAMI_STEPS, BELTRAMI_BLOCK)
    points = BELTRAMI_NODES ** 4
    rel = ex.rel_l2_velocities(nets, res.u)
    with torch.no_grad():
        w = [float(c[-1]) for c in prob.pinnrep.strategy.causal_weights(res.u)]
    print(f"[beltrami] examples/beltrami_spinn.py: {BELTRAMI_NODES}^4 = "
          f"{points} grid points, rank {BELTRAMI_RANK}, 4 x 4 mlp([1,64,64,"
          f"{BELTRAMI_RANK}]), causal eps 1, Adam({lr}) f32, TF32 off, "
          f"solve(inner_steps={BELTRAMI_BLOCK}), {BELTRAMI_STEPS} of the "
          f"stage's 20,000 steps: {seconds:.2f} s; {ms:.3f} ms/step replayed, "
          f"{points * 1e3 / ms:.6g} grid points/s; peak {peak:.2f} GiB; loss "
          f"{res.history[0]:.5g} -> {res.objective:.5g} (per block "
          f"{[round(v, 4) for v in res.history]}); last causal weight per "
          f"equation {[round(v, 4) for v in w]}; rel L2(u,v,w) {rel:.4f} "
          f"(the recipe's eps=1 stage ends at 0.0265 in the JAX package on a "
          f"TPU v5e after 20,000 steps); {_require_graph('beltrami', res)}; "
          f"launches counted (eager step and capture) {counts}; {card}")
    _require_falling("beltrami", res.history)
    _require_counts("beltrami", counts, True)

    rep = prob.pinnrep
    lf = rep.loss_functions
    step = npde.make_step(prob.loss, npde.adam(lr), rep.adaloss,
                          lf.pde_loss_functions, lf.bc_loss_functions,
                          matmul_precision=rep.matmul_precision)
    carry = step.init(res.u, rep.adaloss.init_state(
        len(lf.pde_loss_functions), len(lf.bc_loss_functions), rep.dtype,
        "cuda"))
    runner = GraphedSteps(step, carry,
                          torch.Generator(device="cuda").manual_seed(0))
    with _side_stream(next(iter(runner.theta.values()))):
        for i in range(2):      # the eager step, then the capture
            runner(i)
    _profile_block(runner, 2, BELTRAMI_PROFILE_STEPS, ms / 1e3)
    del runner, step, carry
    return counts


def phase_examples(card: str) -> dict:
    """examples/helmholtz3d_spinn.py at its 2,000 steps, held to
    HELMHOLTZ_LIMIT; examples/taylor_green_spinn.py at 128^3 for
    TG_SPINN_STEPS; examples/taylor_green_ns.py for TG_DENSE_STEPS;
    examples/kuramoto_sivashinsky.py through Adam and
    L-BFGS, held to KS_LIMIT; each new system (and the dense Taylor-Green
    net, and the Burgers PINO family) card against CPU at a small size."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.examples import burgers_pino, helmholtz3d_spinn
    from neuralpde_tpu_torch.examples import kuramoto_sivashinsky as ks
    from neuralpde_tpu_torch.examples import taylor_green_ns
    from neuralpde_tpu_torch.examples import taylor_green_spinn as tgs
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    from neuralpde_tpu_torch.solvers import pino_pde

    tag = "examples-card-vs-cpu"
    _card_vs_cpu_problem(
        "Helmholtz (6,5,4) nodes rank 4 hidden 8, Transformed on every "
        "axis, f32", lambda device, init: helmholtz3d_spinn.build_problem(
            (6, 5, 4), device=device, init_params=init,
            **SMALL_SEPARABLE)[0], tag)
    _card_vs_cpu_problem(
        "Taylor-Green SPINN (6,5,4) nodes rank 4 hidden 8, causal eps 3, "
        "f32", lambda device, init: tgs.make_problem(
            tgs.make_nets(**SMALL_SEPARABLE), 3.0, nodes=(6, 5, 4),
            device=device, init_params=init), tag)
    points = torch.Generator()

    def tg_dense(device, init):
        points.manual_seed(5)
        prob, strategy = taylor_green_ns.make_problem(
            1.0, points=64, bcs_points=16, n_slabs=4, hidden=8,
            device=device, init_params=init)
        strategy.sampler = _cpu_points_sampler(points)
        return prob

    _card_vs_cpu_problem("Taylor-Green dense, two chained periodic "
                         "embeddings, CausalTraining(64, 4 slabs) hidden 8, "
                         "jet, f32", tg_dense, tag)
    _card_vs_cpu_problem("Kuramoto-Sivashinsky mlp([2,32,32,1]) on 51 x 11 "
                         "nodes, jet to order 4, f32",
                         lambda device, init: ks.make_problem(
                             device=device, init_params=init), tag)
    built = [pino_pde._build(
        burgers_pino.build_system(), burgers_pino.make_alg(
            width=8, modes=(4, 3), depth=2, members=3, dx=(1 / 16, 1 / 8)),
        d) for d in ("cpu", "cuda")]
    _card_vs_cpu_line(
        "Burgers PINOPDE family FNO2D w8 m(4,3) d2, 3 members, 17 x 9 grid",
        *[_flat_value_grad(lambda th, b=b: b.total_loss(th, None),
                           _on(built[0].theta0, b.device)) for b in built],
        tag=tag)

    total: dict = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    tj.reset_launch_counts()
    out = helmholtz3d_spinn.run(verbose=False)
    torch.cuda.synchronize()
    counts = tj.launch_counts()
    _add(total, counts)
    print(f"[examples] examples/helmholtz3d_spinn.py: "
          f"{helmholtz3d_spinn.N_GRID}^3 grid rank {helmholtz3d_spinn.RANK}, "
          f"Adam({helmholtz3d_spinn.LR}) f32, "
          f"{helmholtz3d_spinn.ITERS} steps in {out['wall_s']:.3f} s "
          f"({1e3 * out['wall_s'] / helmholtz3d_spinn.ITERS:.3f} ms/step over "
          f"the solve, {out['points_per_s']:.6g} points/s); loss "
          f"{out['loss']:.4e}; rel L2 {out['rel_l2']:.4e} (limit "
          f"{HELMHOLTZ_LIMIT}; the JAX example on a TPU v5e "
          f"{HELMHOLTZ_JAX[0]} at default precision, {HELMHOLTZ_JAX[1]} at "
          f"highest); launches counted (warm-up and timed solves, eager "
          f"steps and captures) {counts}; {card}")
    _require_counts("helmholtz", counts, True)
    if not out["rel_l2"] < HELMHOLTZ_LIMIT:
        raise AssertionError(f"helmholtz: rel L2 {out['rel_l2']}")

    nets = tgs.make_nets()
    prob = tgs.make_problem(nets, tgs.STAGES[0][0])
    res, seconds, ms, counts, peak = _timed_solve(
        prob, npde.adam(tgs.STAGES[0][1]), TG_SPINN_STEPS, TG_SPINN_BLOCK)
    _add(total, counts)
    print(f"[examples] examples/taylor_green_spinn.py: 128^3 grid, 3 fields "
          f"rank {tgs.RANK}, periodic x and y axis nets, causal eps "
          f"{tgs.STAGES[0][0]}, Adam f32, {TG_SPINN_STEPS} of the recipe's "
          f"40,000 steps: {seconds:.2f} s, {ms:.3f} ms/step replayed, "
          f"{128 ** 3 * 1e3 / ms:.6g} grid points/s; peak {peak:.2f} GiB; "
          f"loss per block {[round(v, 5) for v in res.history]}; rel L2(u,v) "
          f"{tgs.rel_l2_uv(nets, res.u):.4f}; {_require_graph('tg', res)}; "
          f"launches counted {counts}; {card}")
    _require_falling("taylor-green spinn", res.history)
    _require_counts("taylor-green spinn", counts, True)

    prob, _ = taylor_green_ns.make_problem(taylor_green_ns.STAGES[0][0])
    loss0 = _loss_and_grad_norm(prob)[0]     # on points of the global RNG
    res, seconds, ms, counts, peak = _timed_solve(
        prob, npde.adam(taylor_green_ns.STAGES[0][1]), TG_DENSE_STEPS,
        TG_DENSE_BLOCK)
    _add(total, counts)
    print(f"[examples] examples/taylor_green_ns.py: 3 x (two chained "
          f"periodic embeddings, mlp([25,128,128,128,1])), CausalTraining("
          f"8192, bcs_points=1024, n_slabs=16), causal eps 1, jet, Adam f32, "
          f"{TG_DENSE_STEPS} of the recipe's 40,000 steps: {seconds:.2f} s, "
          f"{ms:.3f} ms/step replayed; peak {peak:.2f} GiB; loss {loss0:.5g} "
          f"at the start, per block {[round(v, 5) for v in res.history]} "
          f"(each block's last step, on its own points); rel L2(u,v) "
          f"{taylor_green_ns.rel_l2_uv(prob, res.u):.4f}; "
          f"{_require_graph('tg dense', res)}; launches counted {counts}; "
          f"{card}")
    _require_falling("taylor-green dense", [loss0] + res.history)
    _require_counts("taylor-green dense", counts, True)

    tj.reset_launch_counts()
    out = ks.run(verbose=False)
    torch.cuda.synchronize()
    counts = tj.launch_counts()
    _add(total, counts)
    print(f"[examples] examples/kuramoto_sivashinsky.py: mlp([2,32,32,1]) "
          f"on 51 x 11 nodes, jet to order 4, f32: Adam 3000 steps "
          f"{out['stage_s'][0]:.2f} s (rel L2 {out['per_stage'][0][1]:.4e}), "
          f"L-BFGS 600 captured steps {out['stage_s'][1]:.2f} s "
          f"({1e3 * out['stage_s'][1] / 600:.3f} ms/step); loss "
          f"{out['loss']:.4e}; rel L2 {out['rel_l2']:.4e} (limit {KS_LIMIT}, "
          f"the JAX example's on a CPU); launches counted {counts}; {card}")
    _require_counts("kuramoto-sivashinsky", counts, True)
    if not out["rel_l2"] < KS_LIMIT:
        raise AssertionError(f"kuramoto-sivashinsky: rel L2 {out['rel_l2']}")
    return total


@functools.cache
def _script(name: str):
    """``scripts/<name>.py`` loaded by path: the docs runner and the
    measurement scripts that the CPU tests load too."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_docs(card: str) -> dict:
    """Every page of `docs/torch/` under the runner's caps on the card, as
    written (``DEVICE = "cuda"``).  A page that raises or prints a NaN or an
    inf fails.  Returns the wrappers' launches summed over the pages (the
    replays are counted apart by `main`)."""
    runner = _script("torch_docs_runner")
    total: dict = {}
    seconds = 0.0
    for page in runner.pages():
        if not runner.blocks(page):
            print(f"[docs] {page}: no python block")
            continue
        res = runner.run_page(page, mode="capped", device="cuda")
        bad = runner.nonfinite(res)
        if bad:
            raise AssertionError(f"docs page {page} printed a non-finite "
                                 f"metric: {bad}")
        _add(total, res["eager_launches"])
        seconds += res["seconds"]
        shown = " | ".join(ln.strip()[:90] for ln in res["printed"][-3:])
        launched = "/".join(str(n) for n in res["launches"].values())
        replayed = "/".join(str(n) for n in res["replayed_launches"].values())
        print(f"[docs] {page}: {res['seconds']:.2f} s, {res['blocks']} "
              f"blocks ({res['skipped']} skipped); last printed: {shown}; "
              f"tanh_jet2 forward/backward/jvp launches {launched} (by "
              f"replays {replayed})", flush=True)
    print(f"[docs] {len(runner.pages())} pages in {seconds:.1f} s under the "
          f"caps {runner.CAPS}; {card}")
    return total


def _timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{label}] phase took {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated after "
          f"it")
    return out


LBFGS_STEPS = 10                # phase 36: float64 steps, card against CPU
# float64 parameters after LBFGS_STEPS steps, card against CPU: the same
# arithmetic in other reduction orders (cuBLAS and the CPU's), whose
# differences L-BFGS steps grow (~1e-12 after 10 steps on the CPU tests'
# 1-D problem, tests/test_torch_solve.py)
LBFGS_CARD_VS_CPU_RTOL = 1e-8
LBFGS_GRID = 1.0 / 127          # the hybrid recipe's L-BFGS grid
LBFGS_WARM_ADAM = 1_000         # Adam steps before the timed L-BFGS turns
LBFGS_TIMED_STEPS = 50          # a block; a turn of each rule is two
LBFGS_TURNS = 2                 # the rules in order, then reversed, a turn
LBFGS_LINESEARCH_STEPS = 20     # IF bodies a captured step holds


def _lbfgs_steps(prob, n: int, graphed: bool = False):
    """``n`` `npde.lbfgs()` steps through `make_step`, eagerly or (on the
    card, ``graphed``) through `GraphedSteps` as `solve` runs them (the first
    step eager, then replays of its capture) -> per step (CPU copy of the
    parameters, stepsize, line-search steps), and the runner's counts."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.train import GraphedSteps, _side_stream

    rep = prob.pinnrep
    lf = rep.loss_functions
    step = npde.make_step(prob.loss, npde.lbfgs(), rep.adaloss,
                          lf.pde_loss_functions, lf.bc_loss_functions,
                          matmul_precision=rep.matmul_precision)
    carry = step.init(prob.init_params, rep.adaloss.init_state(
        len(lf.pde_loss_functions), len(lf.bc_loss_functions), rep.dtype,
        rep.device))
    generator = torch.Generator(device=rep.device).manual_seed(0)
    opt = carry[1]
    runner = GraphedSteps(step, carry, generator) if graphed else None
    out = []
    with _side_stream(next(iter(carry[0].values()))):
        for i in range(n):
            if runner is not None:
                runner(i)
            else:
                carry, _ = step(carry, generator)
            st = opt.state[opt._params[0]]
            out.append(({k: v.detach().cpu().clone()
                         for k, v in carry[0].items()},
                        float(st["learning_rate"]),
                        int(st["num_linesearch_steps"])))
    return out, (runner.stats() if runner is not None else None)


def _eager_solve(prob, maxiters: int, inner_steps: int, callback):
    """`solve`'s blocks of `npde.lbfgs()` steps run eagerly on the card (the
    device form, reading its search's flag once a trial), timed as
    `solve`'s: a callback after each block -> the last loss."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.train import _side_stream

    rep = prob.pinnrep
    lf = rep.loss_functions
    step = npde.make_step(prob.loss, npde.lbfgs(), rep.adaloss,
                          lf.pde_loss_functions, lf.bc_loss_functions,
                          matmul_precision=rep.matmul_precision)
    carry = step.init(prob.init_params, rep.adaloss.init_state(
        len(lf.pde_loss_functions), len(lf.bc_loss_functions), rep.dtype,
        rep.device))
    generator = torch.Generator(device=rep.device).manual_seed(0)
    with _side_stream(next(iter(carry[0].values()))):
        for it in range(inner_steps, maxiters + 1, inner_steps):
            for _ in range(inner_steps):
                carry, (loss, _) = step(carry, generator)
            callback(it, float(loss), None)
    return float(loss)


def phase_lbfgs(card: str) -> dict:
    """`npde.lbfgs()`, optax.lbfgs()'s rule (`train.LBFGS`), on the card:
    the w64 Poisson `GridTraining(1/127)` jet problem for LBFGS_STEPS
    float64 steps on the card, eagerly and through `solve`'s captured graph,
    and on the CPU, from the same parameters (parameters within
    LBFGS_CARD_VS_CPU_RTOL, line-search counts equal); then the hybrid
    recipe's L-BFGS stage (float32, TF32 off) timed in turns: the captured
    steps, the same device form run eagerly, and `torch.optim.LBFGS`
    passed as a factory (strong Wolfe, one iteration and at most 16
    evaluations a step), from the same Adam-trained parameters."""
    import neuralpde_tpu_torch as npde
    from neuralpde_tpu_torch.accuracy import poisson_2d_system
    from neuralpde_tpu_torch.kernels import lbfgs_zoom as lz
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    def problem(device, dtype):
        return npde.discretize(poisson_2d_system(), npde.PhysicsInformedNN(
            npde.mlp([2, HIDDEN, HIDDEN, 1], dtype=dtype),
            npde.GridTraining(LBFGS_GRID), derivative="jet", dtype=dtype,
            device=device))

    card_prob = problem("cuda", torch.float64)
    cpu_prob = problem("cpu", torch.float64)
    cpu_prob = cpu_prob.with_params(
        {k: v.cpu() for k, v in card_prob.init_params.items()})
    t0 = time.perf_counter()
    on_cpu, _ = _lbfgs_steps(cpu_prob, LBFGS_STEPS)
    cpu_s = time.perf_counter() - t0
    total: dict = {}
    for graphed in (False, True):
        tj.reset_launch_counts()
        zoom = lz.zoom_step_cuda.launches
        t0 = time.perf_counter()
        on_card, stats = _lbfgs_steps(card_prob, LBFGS_STEPS, graphed)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = tj.launch_counts()
        _add(total, counts)
        zoom = lz.zoom_step_cuda.launches - zoom
        worst = max(float(torch.max(torch.abs(a[k] - b[k]))
                          / torch.max(torch.abs(b[k])))
                    for (a, _, _), (b, _, _) in zip(on_card, on_cpu)
                    for k in a)
        how = (f"captured (first step eager, then replays: {stats})"
               if graphed else "eager device form")
        print(f"[lbfgs-card-vs-cpu] w64 Poisson GridTraining(1/127), jet, "
              f"float64, {LBFGS_STEPS} steps, {how}: card {card_s:.2f} s, "
              f"CPU {cpu_s:.2f} s; line-search steps card "
              f"{[c for _, _, c in on_card]}, CPU "
              f"{[c for _, _, c in on_cpu]}; stepsizes card "
              f"{[round(s, 6) for _, s, _ in on_card]}; worst parameter rel "
              f"difference {worst:.3e} (limit {LBFGS_CARD_VS_CPU_RTOL}); "
              f"launches counted {counts}, zoom_step {zoom}; {card}")
        if [c for _, _, c in on_card] != [c for _, _, c in on_cpu]:
            raise AssertionError("lbfgs: line-search counts differ card/CPU")
        if not worst < LBFGS_CARD_VS_CPU_RTOL:
            raise AssertionError(f"lbfgs: card against CPU {worst}")
        _require_counts("lbfgs (float64)", counts, True)
        if not zoom:
            raise AssertionError("lbfgs (float64): zoom_step not launched")
        if graphed and stats["replays"] != LBFGS_STEPS - 1:
            raise AssertionError(f"lbfgs: the step was not replayed: {stats}")

    prob = problem("cuda", torch.float32)
    warm = npde.solve(prob, npde.adam(2e-3), maxiters=LBFGS_WARM_ADAM,
                      inner_steps=100)
    theta = warm.u
    calls = [0]

    def counted(th, lstate):
        calls[0] += 1
        return prob.loss(th, lstate)

    timed = type(prob)(counted, theta, prob.pinnrep)
    torch_lbfgs = (lambda ps: torch.optim.LBFGS(
        list(ps), lr=1.0, max_iter=1, max_eval=16, history_size=10,
        line_search_fn="strong_wolfe"))
    rules = {
        "npde.lbfgs() captured": lambda cb: npde.solve(
            timed, npde.lbfgs(), maxiters=2 * LBFGS_TIMED_STEPS,
            inner_steps=LBFGS_TIMED_STEPS, callback=cb),
        "npde.lbfgs() eager": lambda cb: _eager_solve(
            timed, 2 * LBFGS_TIMED_STEPS, LBFGS_TIMED_STEPS, cb),
        "torch.optim.LBFGS": lambda cb: npde.solve(
            timed, torch_lbfgs, maxiters=2 * LBFGS_TIMED_STEPS,
            inner_steps=LBFGS_TIMED_STEPS, callback=cb)}
    times = {name: [] for name in rules}
    for name in rules:                                   # warm-up, untimed
        rules[name](lambda *a: None)
    for turn in range(LBFGS_TURNS):
        order = list(rules) if turn % 2 == 0 else list(rules)[::-1]
        for name in order + order[::-1]:
            calls[0] = 0
            tj.reset_launch_counts()
            zoom = lz.zoom_step_cuda.launches
            bodies = lz.replayed_counts()["zoom_step"]
            replayed_before = tj.replayed_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks = [time.perf_counter()]

            def block_done(it, loss, aux, marks=marks):
                marks.append(time.perf_counter())

            res = rules[name](block_done)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**20
            counts = tj.launch_counts()
            _add(total, counts)
            replayed = {k: n - replayed_before[k]
                        for k, n in tj.replayed_counts().items()}
            bodies = lz.replayed_counts()["zoom_step"] - bodies
            replayed["zoom_step"] = bodies
            counts = {**counts,
                      "zoom_step": lz.zoom_step_cuda.launches - zoom}
            # the second block: no first step, no capture
            ms = 1e3 * (marks[2] - marks[1]) / LBFGS_TIMED_STEPS
            times[name].append(ms)
            loss = res if isinstance(res, float) else res.objective
            graph = res.aux["cuda_graph"] if not isinstance(res, float) \
                else None
            if name == "npde.lbfgs() captured":
                steps = graph["replays"]
                evals = (f"{1 + bodies / steps:.2f} loss evaluations a "
                         f"replayed step ({bodies} of "
                         f"{LBFGS_LINESEARCH_STEPS * steps} IF bodies "
                         f"entered, {LBFGS_LINESEARCH_STEPS * steps - bodies} "
                         f"skipped); capture {graph['capture_seconds']:.3f} "
                         f"s; {graph}")
                if graph["captures"] != 1 or not bodies:
                    raise AssertionError(f"lbfgs: not replayed: {graph}")
            else:
                evals = (f"{calls[0] / (2 * LBFGS_TIMED_STEPS):.2f} loss "
                         f"evaluations a step")
            print(f"[lbfgs] turn {turn}: {name} on the hybrid recipe's "
                  f"L-BFGS stage (w64 GridTraining(1/127), jet, float32, TF32 "
                  f"off), {2 * LBFGS_TIMED_STEPS} steps in 2 blocks from "
                  f"{LBFGS_WARM_ADAM} Adam steps: {ms:.3f} ms/step over the "
                  f"second block; {evals}; peak {peak:.1f} MiB; loss "
                  f"{loss:.5e}; launches counted {counts}, by replays "
                  f"{replayed}; {card}")
            _require_counts(f"lbfgs ({name})", counts, True)
            if not loss < warm.objective:
                raise AssertionError(f"lbfgs ({name}): loss {loss} "
                                     f"not below Adam's {warm.objective}")
    print(f"[lbfgs] ms/step over {2 * LBFGS_TURNS} runs each: "
          + "; ".join(f"{name} {sorted(round(t, 3) for t in ts)}"
                      for name, ts in times.items()) + f"; {card}")
    return total


BENCH_STEPS = 3                 # timed steps of each rate in phase 37


def phase_bench(card: str) -> dict:
    """`bench_torch.throughput_fields` at bench's sizes with BENCH_STEPS
    timed steps each (the accuracy suite's functions run in phases 9-11):
    every key, finite positive numbers, each mfu_pct in (0, 100]."""
    import bench_torch
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    tj.reset_launch_counts()
    t0 = time.perf_counter()
    fields = bench_torch.throughput_fields(steps=BENCH_STEPS)
    seconds = time.perf_counter() - t0
    counts = tj.launch_counts()
    print(f"[bench] bench_torch.throughput_fields(steps={BENCH_STEPS}) in "
          f"{seconds:.1f} s: {json.dumps(fields)}; launches counted "
          f"{counts}; {card}")
    want = set(bench_torch.THROUGHPUT_KEYS) | set(bench_torch.ADDED)
    if set(fields) != want:
        raise AssertionError(f"bench: keys {sorted(set(fields) ^ want)} "
                             f"missing or unexpected")
    for key, value in fields.items():
        if key in ("metric", "unit", "device"):
            continue
        if not (math.isfinite(value) and value > 0):
            raise AssertionError(f"bench: {key} = {value}")
        if key.endswith("mfu_pct") and not value <= 100:
            raise AssertionError(f"bench: {key} = {value} > 100")
    _require_launched("bench", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward")
    return counts


def _numbers(value):
    """Every number in a JSON value (nested dicts and lists)."""
    if isinstance(value, dict):
        for v in value.values():
            yield from _numbers(v)
    elif isinstance(value, list):
        for v in value:
            yield from _numbers(v)
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        yield value


def _script_lines(name: str, run) -> list[dict]:
    """Run ``run()`` of ``scripts/<name>.py``, echo what it prints, and
    parse its JSON lines: each must hold exactly the script's ``KEYS``
    (the JAX script's, the card's name and power limit) and only finite
    numbers."""
    keys = set(_script(name).KEYS)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run()
    seconds = time.perf_counter() - t0
    printed = out.getvalue().splitlines()
    for line in printed:
        print(f"[scripts] {name}: {line}")
    rows = [json.loads(line) for line in printed if line.startswith("{")]
    if not rows:
        raise AssertionError(f"{name}: printed no JSON line")
    for row in rows:
        if set(row) != keys:
            raise AssertionError(f"{name}: keys {sorted(set(row) ^ keys)} "
                                 f"missing or unexpected")
        if not all(map(math.isfinite, _numbers(row))):
            raise AssertionError(f"{name}: a number is not finite: {row}")
    print(f"[scripts] {name}: {len(rows)} JSON line(s) in {seconds:.1f} s")
    return rows


def phase_scripts(card: str) -> dict:
    """Each measurement script's main function at a smoke budget (module
    note, phase 38); the dense breakdown's classes sum to its busy time
    and hold GEMM and hand-written kernel time."""
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    tj.reset_launch_counts()
    breakdown = _script("torch_profile_breakdown")
    (dense,) = _script_lines("torch_profile_breakdown",
                             lambda: breakdown.run("dense", steps=2))
    cats = dense["categories"]
    print(f"[scripts] dense breakdown: classes sum to "
          f"{sum(cats.values()):.4f} ms, busy {dense['device_busy_ms']:.4f} "
          f"ms a step (limit {breakdown.SUM_RTOL:.0%}); gemm "
          f"{cats['gemm']:.4f} ms, hand_written {cats['hand_written']:.4f} "
          f"ms; {card}")
    if not breakdown.classes_sum_to_busy(dense):
        raise AssertionError("scripts: the breakdown's classes do not sum "
                             "to its busy time")
    if not (cats["gemm"] > 0 and cats["hand_written"] > 0):
        raise AssertionError(f"scripts: the dense breakdown lacks GEMM or "
                             f"hand-written kernel time: {cats}")
    _script_lines("torch_measure_weak", lambda: _script(
        "torch_measure_weak").run(steps=3, repeats=1))
    accuracy_rows = _script("torch_measure_weak_accuracy")
    _script_lines("torch_measure_weak_accuracy", lambda: accuracy_rows.run(
        budget=0.3, seeds=1, problems=("front",),
        labels=[label for label, _, _ in accuracy_rows.configs("front")
                if label == "strong" or "adaptive" in label]))
    _script_lines("torch_measure_ensemble", lambda: _script(
        "torch_measure_ensemble").run(members=(2,), chunk=10, reps=1))
    _script_lines("torch_measure_mfu_accuracy", lambda: _script(
        "torch_measure_mfu_accuracy").run("64:8192", budget=5.0, inner=100))
    _script_lines("torch_probe_tr_parity", lambda: _script(
        "torch_probe_tr_parity").run(maxiters=2))
    budget = _script("torch_probe_allen_cahn_budget")
    _script_lines("torch_probe_allen_cahn_budget", lambda: budget.run(
        50, precisions=("highest",), stages=budget.STAGES[:1]))
    _script_lines("torch_measure_ns_operator", lambda: _script(
        "torch_measure_ns_operator").run("base-fd", iters=4))
    _script_lines("torch_measure_pino_pde", lambda: _script(
        "torch_measure_pino_pde").run(steps=4))
    _script_lines("torch_measure_fieldgrid_derivs", lambda: _script(
        "torch_measure_fieldgrid_derivs").run(iters=4, grids=(16,)))
    counts = tj.launch_counts()
    print(f"[scripts] launches counted {counts}; {card}")
    _require_launched("scripts", counts, "tanh_jet2_forward",
                      "tanh_jet2_backward")
    return counts


def main() -> int:
    name, smi = phase_device()
    card = f"card: {smi}"
    _timed("build", phase_build)
    kernels = _timed("kernel", phase_kernels, card)
    from neuralpde_tpu_torch.kernels import lbfgs_zoom as lz
    from neuralpde_tpu_torch.kernels import sq_sum as sq
    from neuralpde_tpu_torch.kernels import tanh_jet as tj
    runs = {4: lambda: phase_card_vs_cpu(),
            5: lambda: phase_main_path(card),
            6: lambda: phase_transforms(card),
            7: lambda: phase_separable_card_vs_cpu(),
            8: lambda: phase_separable_main(card),
            9: lambda: phase_separable_accuracy(card),
            10: lambda: phase_gauss_newton(card),
            11: lambda: phase_causal(card),
            12: lambda: phase_dense_solve(card),
            13: lambda: phase_dense_causal(card),
            14: lambda: phase_to_accuracy(card),
            15: lambda: phase_adaptive_sampling(card),
            16: lambda: phase_checkpoint(card),
            17: lambda: phase_integrals_card_vs_cpu(),
            18: lambda: phase_integro_differential(card),
            19: lambda: phase_ode_surface(card),
            20: lambda: phase_zoo_card_vs_cpu(card),
            21: lambda: phase_fbpinn(card),
            22: lambda: phase_weak(card),
            23: lambda: phase_zoo_solvers(card),
            24: lambda: phase_stochastic_card_vs_cpu(card),
            25: lambda: phase_sde(card),
            26: lambda: phase_bayesian(card),
            27: lambda: phase_operators_card_vs_cpu(card),
            28: lambda: phase_pino_ode(card),
            29: lambda: phase_pino_pde(card),
            30: lambda: phase_ensembles(card),
            31: lambda: phase_scale_out(card),
            32: lambda: phase_export(card),
            33: lambda: phase_beltrami(card),
            34: lambda: phase_examples(card),
            35: lambda: phase_docs(card),
            36: lambda: phase_lbfgs(card),
            37: lambda: phase_bench(card),
            38: lambda: phase_scripts(card)}
    totals: dict = {}
    checked, sq_checked = set(CHECK_SHAPES), set(SQ_SUM_SHAPES)
    allocated = {}
    for number, run in runs.items():
        tj.LAUNCH_SHAPES.clear()
        tj.reset_replayed_counts()
        lz.reset_launch_counts()
        lz.reset_replayed_counts()
        sq.LAUNCH_SHAPES.clear()
        sq.sq_sum_cuda.launches = 0
        counts = _timed(f"phase {number}", run)
        sq_launches = sq.sq_sum_cuda.launches
        allocated[number] = torch.cuda.memory_allocated()
        replayed = {**tj.replayed_counts(), **lz.replayed_counts()}
        check_launched_shapes(number, checked, sq_checked, kernels, card)
        if number in COUNTED_PHASES:
            counts = {**counts, "zoom_step": lz.zoom_step_cuda.launches,
                      "sq_sum": sq_launches}
            _add(totals, counts)
            _add(totals, replayed)
            print(f"[launches] phase {number}: through the wrappers "
                  f"{counts}, by graph replays {replayed}")
    if allocated[35] > allocated[34] + DOCS_MEMORY_SLACK:
        raise AssertionError(
            f"phase 35 left {(allocated[35] - allocated[34]) / 2**20:.1f} MiB "
            f"allocated beyond phase 34's level (slack "
            f"{DOCS_MEMORY_SLACK / 2**20:.0f} MiB)")
    for k in kernels:
        k["launches"] = totals[k["name"]]
        if not k["launches"]:
            raise AssertionError(f"{k['name']}: not launched by the main "
                                 f"paths (phases {COUNTED_PHASES})")
    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

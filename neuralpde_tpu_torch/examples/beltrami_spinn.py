"""(3+1)-D unsteady Navier-Stokes: Beltrami flow with a separable PINN
(`examples/beltrami_spinn.py` in the port).

The Ethier-Steinman (1994) Beltrami flow with a = d = 1, nu = 1 on
[-1,1]^3 x [0,1]: three momentum equations and continuity, four separable
rank-R fields u(x,y,z,t) = sum_r f(x) g(y) h(z) k(t), one `SeparableNet`
of four ``mlp([1, 64, 64, rank])`` axis nets per field.  Each step
evaluates the full 65^4 = 17,850,625-point tensor-grid residual.  Dirichlet
faces and the initial condition come from the analytic solution; p is
pinned on the t-axis at the origin (gauge).  Causal weighting in t with eps
continuation (three stages of 20,000 Adam steps); true float32 matmuls
(TF32 off) for training and evaluation.

The x, y and z axis nets take second derivatives, which go through the
``tanh_jet2`` kernel on the card; the t axis takes a first derivative
(tanh's plain Taylor series).

Run:

    python -m neuralpde_tpu_torch.examples.beltrami_spinn [--nodes 65]
        [--rank 64] [--iters 20000] [--stages "1:1e-3,10:5e-4,30:5e-4"]
        [--save theta.pt] [--load theta.pt] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import neuralpde_tpu_torch as npde
from neuralpde_tpu_torch import (
    DepVar, Differential, Domain, Eq, Interval, NonAdaptiveLoss, PDESystem,
    PhysicsInformedNN, SeparableNet, SeparableTraining, adam, depvar_params,
    discretize, matmul_precision, mlp, solve, symbols,
)

A = 1.0
D = 1.0
NU = 1.0
DEFAULT_STAGES = ((1.0, 1e-3), (10.0, 5e-4), (30.0, 5e-4))   # (causal eps, lr)
# 3 velocity ICs at weight 100, 18 faces at 10, the gauge at 10
BC_WEIGHTS = [100.0] * 3 + [10.0] * 18 + [10.0]
EVAL_TIMES = (0.25, 0.5, 1.0)


def analytic(sym_x, sym_y, sym_z, sym_t):
    """Symbolic analytic Beltrami fields (u, v, w, p) at the given
    coordinate expressions (numbers or symbols)."""
    e, s, c = npde.exp, npde.sin, npde.cos
    dec = e(-(D ** 2) * sym_t)
    ua = -A * (e(A * sym_x) * s(A * sym_y + D * sym_z)
               + e(A * sym_z) * c(A * sym_x + D * sym_y)) * dec
    va = -A * (e(A * sym_y) * s(A * sym_z + D * sym_x)
               + e(A * sym_x) * c(A * sym_y + D * sym_z)) * dec
    wa = -A * (e(A * sym_z) * s(A * sym_x + D * sym_y)
               + e(A * sym_y) * c(A * sym_z + D * sym_x)) * dec
    pa = (-(A ** 2) / 2.0) * (
        e(2 * A * sym_x) + e(2 * A * sym_y) + e(2 * A * sym_z)
        + 2 * s(A * sym_x + D * sym_y) * c(A * sym_z + D * sym_x)
        * e(A * (sym_y + sym_z))
        + 2 * s(A * sym_y + D * sym_z) * c(A * sym_x + D * sym_y)
        * e(A * (sym_z + sym_x))
        + 2 * s(A * sym_z + D * sym_x) * c(A * sym_y + D * sym_z)
        * e(A * (sym_x + sym_y))) * e(-2 * (D ** 2) * sym_t)
    return ua, va, wa, pa


def analytic_np(X, Y, Z, T):
    """The analytic velocities in numpy (the evaluation reference)."""
    dec = np.exp(-(D ** 2) * T)
    ua = -A * (np.exp(A * X) * np.sin(A * Y + D * Z)
               + np.exp(A * Z) * np.cos(A * X + D * Y)) * dec
    va = -A * (np.exp(A * Y) * np.sin(A * Z + D * X)
               + np.exp(A * X) * np.cos(A * Y + D * Z)) * dec
    wa = -A * (np.exp(A * Z) * np.sin(A * X + D * Y)
               + np.exp(A * Y) * np.cos(A * Z + D * X)) * dec
    return ua, va, wa


def build_system() -> PDESystem:
    """Four coupled equations (momentum in x, y, z and continuity), the
    three velocity ICs, the 18 Dirichlet faces and the pressure gauge."""
    x, y, z, t = symbols("x y z t")
    u, v, w, p = DepVar("u"), DepVar("v"), DepVar("w"), DepVar("p")
    Dt = Differential(t)
    Dx, Dy, Dz = Differential(x), Differential(y), Differential(z)
    Dxx, Dyy, Dzz = Dx ** 2, Dy ** 2, Dz ** 2
    U, V, W, P = u(x, y, z, t), v(x, y, z, t), w(x, y, z, t), p(x, y, z, t)

    def lap(F):
        return Dxx(F) + Dyy(F) + Dzz(F)

    eqs = [
        Eq(Dt(U) + U * Dx(U) + V * Dy(U) + W * Dz(U) + Dx(P), NU * lap(U)),
        Eq(Dt(V) + U * Dx(V) + V * Dy(V) + W * Dz(V) + Dy(P), NU * lap(V)),
        Eq(Dt(W) + U * Dx(W) + V * Dy(W) + W * Dz(W) + Dz(P), NU * lap(W)),
        Eq(Dx(U) + Dy(V) + Dz(W), 0.0),
    ]
    ua0, va0, wa0, _ = analytic(x, y, z, 0.0)
    bcs = [Eq(u(x, y, z, 0.0), ua0), Eq(v(x, y, z, 0.0), va0),
           Eq(w(x, y, z, 0.0), wa0)]
    for const, sym in [(-1.0, "x"), (1.0, "x"), (-1.0, "y"), (1.0, "y"),
                       (-1.0, "z"), (1.0, "z")]:
        sub = {"x": x, "y": y, "z": z}
        sub[sym] = const
        ua_, va_, wa_, _ = analytic(sub["x"], sub["y"], sub["z"], t)
        bcs += [Eq(u(sub["x"], sub["y"], sub["z"], t), ua_),
                Eq(v(sub["x"], sub["y"], sub["z"], t), va_),
                Eq(w(sub["x"], sub["y"], sub["z"], t), wa_)]
    _, _, _, pa0 = analytic(0.0, 0.0, 0.0, t)
    bcs.append(Eq(p(0.0, 0.0, 0.0, t), pa0))
    domains = [Domain(x, Interval(-1, 1)), Domain(y, Interval(-1, 1)),
               Domain(z, Interval(-1, 1)), Domain(t, Interval(0, 1))]
    return PDESystem(eqs, bcs, domains, [x, y, z, t], [U, V, W, P])


def make_nets(rank: int, hidden: int = 64, dtype=torch.float32) -> list:
    """One `SeparableNet` per field (u, v, w, p), four ``mlp([1, hidden,
    hidden, rank])`` axis nets each."""
    return [SeparableNet([mlp([1, hidden, hidden, rank], dtype=dtype)
                          for _ in range(4)]) for _ in range(4)]


def make_problem(nets: list, causal_eps: float, *, nodes=65,
                 precision: str = "highest", dtype=torch.float32,
                 device="cuda", init_params=None):
    """One causal stage on the static tensor grid: ``nodes`` per axis (an
    int, or one count per axis x, y, z, t), the BC weights of
    `BC_WEIGHTS`."""
    counts = [nodes] * 4 if isinstance(nodes, int) else list(nodes)
    dx = [2.0 / (n - 1) for n in counts[:3]] + [1.0 / (counts[3] - 1)]
    system = build_system()
    strategy = SeparableTraining(dx=dx, causal=system.ivs[3],
                                 causal_eps=causal_eps)
    return discretize(system, PhysicsInformedNN(
        nets, strategy, dtype=dtype, device=device, init_params=init_params,
        matmul_precision=precision,
        adaptive_loss=NonAdaptiveLoss(bc_loss_weights=BC_WEIGHTS)))


def rel_l2_velocities(nets: list, theta: dict, n_eval: int = 33) -> float:
    """rel L2 of (u, v, w) on an n_eval^3 grid at t in 0.25, 0.5, 1.0
    against the analytic field, under true float32 matmuls."""
    xs = np.linspace(-1, 1, n_eval)
    like = next(iter(theta.values()))
    nx = torch.tensor(xs, dtype=like.dtype, device=like.device)
    num2 = den2 = 0.0
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    for tv in EVAL_TIMES:
        want = analytic_np(X, Y, Z, tv)
        nt = torch.tensor([tv], dtype=like.dtype, device=like.device)
        with torch.no_grad(), matmul_precision("highest"):
            preds = [nets[i].grid(depvar_params(theta, name), [nx, nx, nx, nt])
                     [..., 0].double().cpu().numpy()
                     for i, name in enumerate("uvw")]
        for pred, ana in zip(preds, want):
            num2 += np.linalg.norm(pred - ana) ** 2
            den2 += np.linalg.norm(ana) ** 2
    return float(np.sqrt(num2 / den2))


def run(nodes=65, rank: int = 64, iters: int = 20000,
        precision: str = "highest", stages=DEFAULT_STAGES, theta=None,
        save: str | None = None, verbose: bool = True, *, hidden: int = 64,
        n_eval: int = 33, device="cuda") -> dict:
    """The full eps-continuation recipe: each stage `solve`s ``iters`` Adam
    steps from the last one's parameters (``theta`` warm-starts the
    first).  Returns ``{"rel_l2", "wall_s", "per_stage": [(eps, rel_l2),
    ...], "losses": [...]}``."""
    nets = make_nets(rank, hidden)
    per_stage, losses = [], []
    rel = float("nan")
    t0 = time.perf_counter()
    for eps, lr in stages:
        prob = make_problem(nets, eps, nodes=nodes, precision=precision,
                            device=device)
        if theta is not None:
            prob = prob.with_params(
                {k: v.to(prob.pinnrep.device) for k, v in theta.items()})
        res = solve(prob, adam(lr), maxiters=iters,
                    inner_steps=min(500, iters))
        theta = res.u
        rel = rel_l2_velocities(nets, theta, n_eval)
        per_stage.append((eps, rel))
        losses.append(res.objective)
        if verbose:
            print(f"eps={eps} nodes={nodes}^4 rank={rank} prec={precision}: "
                  f"rel L2(u,v,w) = {rel:.4f} (loss {res.objective:.3e}, "
                  f"t = {time.perf_counter() - t0:.1f}s)", flush=True)
        if save:
            torch.save({k: v.detach().cpu() for k, v in theta.items()}, save)
    return {"rel_l2": rel, "wall_s": round(time.perf_counter() - t0, 1),
            "per_stage": per_stage, "losses": losses}


def parse_stages(text: str) -> list:
    """``"1:1e-3,10:5e-4"`` -> ``[(1.0, 1e-3), (10.0, 5e-4)]``."""
    return [(float(s.split(":")[0]), float(s.split(":")[1]))
            for s in text.split(",")]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=65)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20000,
                    help="iters per continuation stage")
    ap.add_argument("--precision", default="highest",
                    choices=["default", "highest"])
    ap.add_argument("--stages", default="1:1e-3,10:5e-4",
                    help="comma list of eps:lr continuation stages")
    ap.add_argument("--save", default=None,
                    help="save the trained params (torch.save) to this path")
    ap.add_argument("--load", default=None,
                    help="warm-start from a --save'd params file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    theta = (torch.load(args.load, weights_only=True) if args.load
             else None)
    out = run(nodes=args.nodes, rank=args.rank, iters=args.iters,
              precision=args.precision, stages=parse_stages(args.stages),
              theta=theta, save=args.save, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

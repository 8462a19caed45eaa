"""Deep-ensemble PINN training (`neuralpde_tpu.parallel.ensemble`): N
independent initializations trained together, one optimizer step for all.

Beyond the reference (which trains one network per solve,
src/discretize.jl:430-470).  It answers the seed lottery (keep the best
basin) and gives the classic deep-ensemble spread as epistemic
uncertainty (Lakshminarayanan et al. 2017).

On one card the members' parameters are stacked on a leading axis.  A step
evaluates each member's loss on its slice of the stacked parameters (the
members one after another, each drawing its own points from the solve's
generator), takes the gradient of the sum of the member losses (the slices
are disjoint, so each member gets exactly its own gradient) and updates the
stacked leaves with one `train.Adam`, which being elementwise is each
member's Adam.  On the card that step is captured as one CUDA graph and
replayed, as `solve`'s is.  Under `train.LBFGS` the step takes the members
in turn, each with its own memory and line search, and runs eagerly.

``mesh=`` shards the member axis over the ranks of a mesh
(`parallel.mesh`): each rank trains its ``n_ensemble / W`` members in its
own step, which holds no collective, and the ranks gather the members'
losses once a block (so that they stop together) and the members at the
end, so every rank returns the whole result.

Usage:
    prob = discretize(system, PhysicsInformedNN(mlp([1, 16, 1]), strat))
    res = solve_ensemble(prob, adam(2e-3), maxiters=2000, n_ensemble=8)
    res.best_index, res.losses       # winner and per-member objectives
    theta = res.best                 # the winner's flat parameters
    mean, std = res.mean_and_std(cord)
"""

from __future__ import annotations

import json
import math
import os
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..compile.lower import depvar_params
from ..config import matmul_precision
from ..train import LBFGS, GraphedSteps, TrainStep, _side_stream, adam
from .mesh import check_mesh, gather_ranks, mesh_slice, no_mesh


@dataclass
class EnsembleResult:
    """Stacked (leading axis = member) parameters and per-member objectives."""

    members: Any               # flat dict, every leaf (n_ensemble, ...)
    losses: Any                # (n_ensemble,) final per-member losses
    iterations: int
    history: list              # bounded list of (iteration, (n_ensemble,) losses)
    pinnrep: Any = None
    aux: dict | None = None    # "cuda_graph" counts on the card

    @property
    def n_ensemble(self) -> int:
        return int(next(iter(self.members.values())).shape[0])

    @property
    def best_index(self) -> int:
        return int(torch.argmin(torch.as_tensor(self.losses)))

    @property
    def best(self):
        """Flat parameters of the lowest-loss member."""
        return self.member(self.best_index)

    def member(self, i: int) -> dict:
        return {k: v[i] for k, v in self.members.items()}

    @torch.no_grad()
    def predict(self, cord, depvar: str | None = None):
        """Every member at cord (in_dim, N) -> (n_ensemble, out, N)."""
        if self.pinnrep is None:
            raise ValueError("predict needs the pinnrep (train via "
                             "solve_ensemble to attach it)")
        rep = self.pinnrep
        phi = rep.phi
        if rep.multioutput:
            if depvar is None:
                raise ValueError(
                    f"multi-output problem: pick depvar= from {rep.depvars}")
            phi = phi[rep.depvars.index(depvar)]
        return torch.stack([
            phi(cord, depvar_params(self.member(i),
                                    depvar if rep.multioutput else None))
            for i in range(self.n_ensemble)])

    def mean_and_std(self, cord, depvar: str | None = None):
        """Deep-ensemble predictive mean and (population) std at cord."""
        preds = self.predict(cord, depvar)
        return torch.mean(preds, dim=0), torch.std(preds, dim=0, correction=0)


def _member_init_fn(prob):
    """``(generator) -> flat params`` like ``prob.init_params``: each
    chain's parameters reset from the generator (in depvar order), in the
    problem's dtype and on its device, with an inverse problem's ``"p"``
    copied from the problem's start value (the same for every member)."""
    rep = prob.pinnrep
    phis = rep.phi if rep.multioutput else [rep.phi]

    def init(generator):
        flat = {k: v for k, v in prob.init_params.items()
                if not k.startswith("depvar.")}
        for name, phi in zip(rep.depvars, phis):
            phi.module.reset_parameters(generator)
            prefix = f"depvar.{name}." if rep.multioutput else "depvar."
            for k, v in phi.module.named_parameters():
                flat[prefix + k] = v.detach().to(device=rep.device,
                                                 dtype=rep.dtype, copy=True)
        return flat

    return init


class EnsembleStep(TrainStep):
    """`TrainStep` over stacked parameters: ``run`` evaluates every member's
    loss on its slice (adaptive state per member, the member's slice of the
    stacked state), back-propagates their sum and steps the optimizer once;
    it returns the ``(n_ensemble,)`` losses and the members' aux stacked."""

    def __init__(self, loss_fn, optimizer, n_ensemble, adaloss=None,
                 pde_loss_fns=(), bc_loss_fns=(), precision=None):
        super().__init__(loss_fn, optimizer, adaloss, pde_loss_fns,
                         bc_loss_fns, precision)
        self.n = n_ensemble

    def run(self, theta, opt, ada_state, generator, reweight):
        if self.needs_closure(opt):
            return self._run_members(theta, opt, ada_state, generator,
                                     reweight)
        opt.zero_grad(set_to_none=True)
        with matmul_precision(self.precision):
            losses, auxes = [], []
            for m in range(self.n):
                loss, aux = self.loss_fn(
                    self._slice(theta, m),
                    {"generator": generator,
                     "adaptive": self._slice(ada_state, m)})
                losses.append(loss)
                auxes.append({k: v.detach() for k, v in aux.items()})
            losses = torch.stack(losses)
            losses.sum().backward()
            if reweight:
                for m in range(self.n):
                    self._reweight(self._slice(theta, m),
                                   self._slice(ada_state, m), auxes[m],
                                   generator)
        opt.step()
        aux = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]} \
            if auxes and auxes[0] else {}
        return losses.detach(), aux

    def _run_members(self, theta, opt, ada_state, generator, reweight):
        """`LBFGS`: the members in turn, each with its own line search (its
        evaluations draw the member's points again), as the JAX package's
        ``vmap`` of `optax.lbfgs` steps each member alone."""
        if not isinstance(opt, LBFGS):
            raise ValueError("solve_ensemble runs L-BFGS as npde.lbfgs(), "
                             "one line search a member")
        out = [self._run_closure(theta, opt, ada_state, generator, reweight,
                                 member=m) for m in range(self.n)]
        aux = {k: torch.stack([a[k] for _, a in out]) for k in out[0][1]}
        return torch.stack([loss for loss, _ in out]), aux


def _keep_newest(history: list) -> list:
    """Halve a history, keeping its newest entry and every other one back
    from it (``history[::2]`` would drop the newest pair of an even-length
    list)."""
    return history[::-2][::-1]


def solve_ensemble(prob, optimizer=None, maxiters: int = 1000, *,
                   n_ensemble: int = 8, generator=None, seed: int = 0,
                   inner_steps: int = 1, mesh=None,
                   abstol: float | None = None, verbose: bool = False,
                   callback=None, checkpoint_path: str | None = None,
                   checkpoint_every: int | None = None,
                   history_cap: int = 1024,
                   member_init=None) -> EnsembleResult:
    """Train ``n_ensemble`` independent initializations of a
    `TrainingProblem` (or a bare problem with ``member_init``) together.

    * Initializations: ``member_init(gen)`` is called for members 0, 1, ...
      in order with one CPU generator seeded with ``seed``; the default
      resets the problem's chains from it (`_member_init_fn`).  The step's
      draws come from ``generator`` (default: seeded with ``seed`` on the
      problem's device); each member draws its own points, after the
      members before it.
    * ``mesh``: shard the members over the mesh's ranks (module note);
      ``n_ensemble`` must be a multiple of its size.  Every rank draws all
      the initializations and keeps its own, so member m starts from the
      same parameters whatever the mesh; a rank's members draw their points
      from its generator (default: seeded with ``seed`` plus the rank), so
      with a stochastic strategy member m's points depend on the mesh
      (with a deterministic one the members are those of the run without
      it).  ``checkpoint_path`` then holds one ``rank<r>`` directory a
      rank.
    * Stopping: ``abstol`` stops when the best member crosses it; a member
      that diverges does not stop the run (argmin ignores it); all members
      diverged does.
    * ``callback(iteration, losses)`` runs once a block of ``inner_steps``
      with the ``(n_ensemble,)`` losses as numpy; a true return stops.
    * ``checkpoint_path`` (every ``checkpoint_every`` iterations, default
      10 blocks, and at the end): the stacked parameters, the optimizer, the
      generator, the adaptive state and the losses; a rerun resumes from it.
    * ``history_cap``: ``res.history`` holds ``(iteration, losses)`` pairs
      and is halved, keeping the newest, whenever it outgrows the cap.

    Every member steps with one optimizer over the stacked parameters:
    `adam` is elementwise, so one update steps every member; `lbfgs` steps
    the members in turn, each with its own memory and line search (eagerly,
    also on the card).  On the card ``res.aux["cuda_graph"]`` counts the
    captures and replays.
    """
    mesh = check_mesh(mesh)
    mine = (mesh_slice(n_ensemble, mesh, "n_ensemble") if mesh is not None
            else slice(0, n_ensemble))
    optimizer = optimizer or adam(1e-3)
    rep = getattr(prob, "pinnrep", None)
    if rep is None and member_init is None:
        raise ValueError("a problem without a pinnrep needs member_init=")
    if rep is not None:
        adaloss = rep.adaloss
        lf = rep.loss_functions
        pde_fns, bc_fns = lf.pde_loss_functions, lf.bc_loss_functions
        device, dtype = rep.device, rep.dtype
        precision = rep.matmul_precision
    else:
        from ..adaptive import NonAdaptiveLoss

        like = next(iter(prob.init_params.values()))
        adaloss, pde_fns, bc_fns = NonAdaptiveLoss(), (), ()
        device, dtype = like.device, like.dtype.to_real()
        precision = getattr(prob, "matmul_precision", None)

    init_gen = torch.Generator().manual_seed(seed)
    init = member_init or _member_init_fn(prob)
    inits = [init(init_gen) for _ in range(n_ensemble)][mine]
    n_run = len(inits)
    params = {k: torch.stack([torch.as_tensor(p[k]).to(device)
                              for p in inits]) for k in inits[0]}
    one = adaloss.init_state(len(pde_fns), len(bc_fns), dtype, device)
    ada_state = {k: torch.stack([v] * n_run) for k, v in one.items()}
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            seed + mine.start // max(n_run, 1))
    if mesh is not None and checkpoint_path is not None:
        checkpoint_path = os.path.join(checkpoint_path,
                                       f"rank{mine.start // n_run}")

    step = EnsembleStep(prob.loss, optimizer, n_run,
                        adaloss if rep is not None else None, pde_fns,
                        bc_fns, precision)
    carry = step.init(params, ada_state)
    theta, opt, ada_state, _ = carry

    from ..utils.checkpoint import (
        has_checkpoint, restore_checkpoint, save_checkpoint,
    )

    it = 0
    losses = torch.full((n_run,), math.inf, dtype=dtype, device=device)
    if has_checkpoint(checkpoint_path):
        it = restore_checkpoint(checkpoint_path, theta, opt, generator,
                                ada_state)[2]
        with open(os.path.join(checkpoint_path, "meta.json")) as f:
            losses = torch.as_tensor(json.load(f)["losses"], dtype=dtype,
                                     device=device)
        if verbose:
            print(f"[ensemble] resumed from {checkpoint_path} at iter {it}")
    ckpt_every = (checkpoint_every if checkpoint_every is not None
                  else 10 * inner_steps)
    last_ckpt = it

    def save():
        save_checkpoint(checkpoint_path, theta, opt, iteration=it,
                        generator=generator, adaptive_state=ada_state,
                        extra={"losses": [float(v) for v in losses.cpu()]})

    graphed = (GraphedSteps(step, carry, generator)
               if torch.device(device).type == "cuda" else None)
    history = []
    # the members' losses shard no batch of their own, and hold no
    # collective in the step
    with no_mesh(), _side_stream(next(iter(theta.values()))):
        while it < maxiters:
            for i in range(it, it + inner_steps):
                if graphed is not None:
                    out, _ = graphed(i)
                else:
                    out, _ = step.run(theta, opt, ada_state, generator,
                                      step.reweights(i))
            it += inner_steps
            losses = out.clone()
            lnp = (losses if mesh is None
                   else gather_ranks(losses, mesh)).cpu().numpy()
            history.append((it, lnp))
            if len(history) > history_cap:
                history = _keep_newest(history)
            finite = np.isfinite(lnp)
            best = float(np.min(lnp[finite])) if finite.any() else math.nan
            if verbose:
                print(f"[ensemble] iter {it:6d}  best {best:.6g}  "
                      f"median {float(np.nanmedian(lnp)):.6g}")
            if checkpoint_path is not None and it - last_ckpt >= ckpt_every:
                save()
                last_ckpt = it
            stop = callback is not None and callback(it, lnp)
            if stop or (abstol is not None and best < abstol):
                break
            if not finite.any():
                warnings.warn(f"all {n_ensemble} ensemble members diverged "
                              f"at iteration {it}; stopping")
                break
    if checkpoint_path is not None and it > last_ckpt:
        save()
    aux = {"cuda_graph": graphed.stats()} if graphed is not None else {}
    members = {k: v.detach() for k, v in theta.items()}
    if mesh is not None:
        members = {k: gather_ranks(v, mesh) for k, v in members.items()}
        losses = gather_ranks(losses, mesh)
    return EnsembleResult(members=members, losses=losses, iterations=it,
                          history=history, pinnrep=rep, aux=aux)

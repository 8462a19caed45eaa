"""Steady training steps of the Beltrami SPINN on its static grid, on one
card.

`steady_steps` with the configuration's own problem (`problem_beltrami`):
one ``solve`` runs one step a block; its first ``check_steps`` steps are
set-up and are held to the reference (`reference.beltrami`); the window
then replays the captured step for ``--seconds``; the rate is the counted
points (the interior grid and each condition's points) of every window
step over the window.  The layer readings add the program's count of grid
contractions a step (``SeparableTraining.grid_contractions``, summed; none
where the program has no such counter).  A traced run then traces one
block of a fresh ``solve`` from the window's parameters.
"""

from __future__ import annotations

import torch

import harness
import problem_beltrami
import problems
from traffic import steady_steps


def grid_contractions(prob):
    """The sum of the strategy's per-loss counts, or None without them."""
    counts = getattr(prob.pinnrep.strategy, "grid_contractions", None)
    return None if counts is None else sum(counts)


def run(ctx) -> dict:
    npde, device, wl = ctx.npde, ctx.device, ctx.workload
    problem = problems.problem_of(ctx.config, wl)
    params_seed, points_seed = problems.seeds(ctx.seed, 2)
    init = problem_beltrami.init_params(problem, params_seed, device)
    prob = problem_beltrami.build(npde, problem, init, device)
    ctx.mark("problem built")
    held = harness.HeldOptimizer(npde, problem["optimizer"]["lr"])
    first = harness.FirstSteps(held, prob, init, wl["check_steps"])
    generator = torch.Generator(device=device).manual_seed(points_seed)
    res, st = steady_steps.train(ctx, prob, held, first, generator)
    stamps, t0, failed = st["stamps"], st["t0"], st["failed"]
    if t0 is None or not stamps:
        raise RuntimeError("the solve stopped before the window began "
                           f"(losses {first.losses})")
    window_s = stamps[-1] - t0
    steps = len(stamps)
    graphs = res.aux.get("cuda_graph", {})
    harness.log(f"window: {steps} steps in {window_s:.6f} s; captures "
                f"{graphs}; last loss {res.objective}")
    layer = {
        "step_s": window_s / steps,
        "model_flops": problem_beltrami.model_flops(problem),
        "capture_setup_s": graphs.get("capture_seconds"),
        "grid_contractions": grid_contractions(prob),
        "breakdown": None,
        "trace_steps": wl["trace_steps"],
    }
    fields = harness.card_fields(1, device)
    if ctx.trace:
        layer["breakdown"] = harness.traced_block(
            npde, prob, res.u, problem["optimizer"]["lr"], wl["trace_steps"],
            points_seed + 1, device)
    layer["launch_shapes"] = ctx.launch_shapes()
    # the program's state goes before the reference runs
    del res, prob, st
    held.opt = None
    harness.free(device)
    ctx.mark("reference starts")
    reference = problem_beltrami.follow_reference(problem, init,
                                                  wl["check_steps"])
    ctx.mark("reference done")
    return {
        "e2e": {"points_per_s": problem_beltrami.counted_points(problem)
                * steps / window_s,
                "setup_s": t0 - ctx.t_start},
        "attempted": steps, "failed": failed, "program": first.readings(),
        "reference": reference, "device": fields, "layer": layer,
    }

"""Back-to-back trials to an accuracy target on one card.

Each trial starts from a fresh initialization made on the card and trains
with Adam in ``solve`` calls of ``chunk_steps`` steps (blocks of
``block_steps``), each a new solve with its own captured graphs, until the
benchmark's own RMS error on the ``rms_grid``-squared grid is below
``target_rms``; a trial that passes ``trial_cap_s`` fails.  A trial's time
runs from before its initialization to the RMS reading that ends it.  The
trials are the members of a fixed pool (``pool`` initializations and point
streams, from ``pool_seed``) in an order drawn from ``--seed``, cycled, so
that every seed runs the same work in another order.  The trial still
running when the window ends is stopped at its next block and left out of
both counts, unless no trial has finished: then it counts as one attempted
and failed.

Set-up holds the program to the reference on the first ``check_steps``
steps of one solve of the cell's problem from ``--seed`` (one step a
block), then runs the recipe's untimed warm-up solve of ``warmup_steps``.
A traced run traces one more trial after a warm-up trial, after the
window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import harness
import problems
from reference import dense


class Trials:
    """The pool of trials and what the window measured."""

    def __init__(self, ctx, problem: dict, prob):
        wl = ctx.workload
        self.ctx, self.problem, self.prob, self.wl = ctx, problem, prob, wl
        pool = wl["pool"]
        seeds = problems.seeds(wl["pool_seed"], 2 * pool)
        self.param_seeds, self.point_seeds = seeds[:pool], seeds[pool:]
        self.order = np.random.default_rng(ctx.seed).permutation(pool)
        self.next = 0

    def run_one(self, deadline: float | None):
        """One trial -> (seconds, reached, capture seconds, solves), or
        None when ``deadline`` (host clock) passed first."""
        npde, wl, device = self.ctx.npde, self.wl, self.ctx.device
        member = int(self.order[self.next % len(self.order)])
        self.next += 1
        start = time.perf_counter()
        theta = {problems.PREFIX + k: v for k, v in problems.init_params(
            self.problem, self.param_seeds[member], device).items()}
        captured, chunk = 0.0, 0
        stop = (None if deadline is None else
                lambda it, loss, aux: time.perf_counter() >= deadline)
        while True:
            generator = torch.Generator(device=device).manual_seed(
                self.point_seeds[member] + chunk)
            res = npde.solve(self.prob.with_params(theta),
                             npde.adam(self.problem["optimizer"]["lr"]),
                             maxiters=wl["chunk_steps"],
                             inner_steps=wl["block_steps"],
                             generator=generator, callback=stop)
            captured += res.aux.get("cuda_graph", {}).get(
                "capture_seconds", 0.0)
            if res.iterations < wl["chunk_steps"]:
                return None
            theta = res.u
            err = dense.rms_error(
                {k[len(problems.PREFIX):]: v for k, v in theta.items()},
                self.problem["layers"], True, wl["rms_grid"])
            seconds = time.perf_counter() - start
            if err < wl["target_rms"]:
                return seconds, True, captured, chunk + 1
            if seconds > wl["trial_cap_s"]:
                return seconds, False, captured, chunk + 1
            chunk += 1


def run(ctx) -> dict:
    npde, device, wl = ctx.npde, ctx.device, ctx.workload
    problem = problems.problem_of(ctx.config, wl)
    params_seed, points_seed = problems.seeds(ctx.seed, 2)
    init = problems.init_params(problem, params_seed, device)
    prob = problems.build(npde, problem, init, device)
    program, capture_setup = harness.first_steps(
        npde, problem, prob, init, points_seed, wl["check_steps"], device)
    ctx.mark("checked steps done")
    warm = npde.solve(prob, npde.adam(problem["optimizer"]["lr"]),
                      maxiters=wl["warmup_steps"],
                      inner_steps=wl["block_steps"])
    capture_setup = (capture_setup or 0.0) + warm.aux.get(
        "cuda_graph", {}).get("capture_seconds", 0.0)
    del warm
    ctx.mark("warm-up solve done")
    trials = Trials(ctx, problem, prob)
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    done, captured, left_out = [], 0.0, 0
    while time.perf_counter() < deadline:
        out = trials.run_one(deadline)
        if out is None:
            left_out += 1
            break
        done.append(out)
        captured += out[2]
    window_s = time.perf_counter() - t0
    reached = [s for s, ok, _, _ in done if ok]
    attempted, failed = len(done), len(done) - len(reached)
    if not done:
        attempted, failed = 1, 1
    harness.log(f"window {window_s:.4f} s: {len(done)} trials, "
                f"{len(reached)} reached the target, {left_out} left out; "
                f"(seconds, capture seconds, solves) "
                f"{[(round(s, 4), round(c, 4), n) for s, _, c, n in done]}")
    layer = {"capture_setup_s": capture_setup,
             "capture_per_trial_s": captured / len(done) if done else None,
             "breakdown": None}
    if ctx.trace:
        layer["breakdown"] = traced_trial(trials, device)
    fields = harness.card_fields(1, device)
    del prob, trials
    harness.free(device)
    reference = problems.follow_reference(problem, init, points_seed,
                                          wl["check_steps"])
    e2e = {"setup_s": t0 - ctx.t_start}
    if reached:
        e2e["to_target_s"] = sum(reached) / len(reached)
        e2e["to_target_s_p80"] = float(np.percentile(reached, 80))
    return {"e2e": e2e, "attempted": attempted, "failed": failed,
            "program": program, "reference": reference, "device": fields,
            "layer": layer}


def traced_trial(trials: Trials, device) -> dict:
    """The breakdown of one trial traced after a warm-up trial."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from reference import profile as frozen

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    trials.run_one(None)
    prof.step()
    start = time.perf_counter()
    trials.run_one(None)
    harness.sync(device)
    window_s = time.perf_counter() - start
    prof.stop()
    dev, host = frozen.split_events(prof.events())
    return frozen.breakdown(dev, host, window_s)

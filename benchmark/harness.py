"""What the traffic drivers share: the program's optimizer held for the
check, the first steps' readings, the traced window, the device's fields.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time

import torch

import problems
from reference import profile

B1 = 0.9            # Adam's first-moment decay (the configuration's optax.adam)


def log(*parts) -> None:
    print("[benchmark]", *parts, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Return the cached blocks of freed tensors to the card."""
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class HeldOptimizer:
    """An optimizer factory for ``solve`` that keeps the optimizer it
    makes, so that the check can read the program's parameters and its
    optimizer state between steps."""

    def __init__(self, npde, lr: float):
        self.factory = npde.adam(lr)
        self.opt = None

    def __call__(self, params):
        self.opt = self.factory(params)
        return self.opt

    def params(self, names) -> dict:
        """The program's current parameters under ``names`` (the order in
        which the problem holds them)."""
        return dict(zip(names, self.opt.param_groups[0]["params"]))

    def first_gradient(self, names) -> dict:
        """Each leaf's gradient of the first step as the optimizer holds it
        after that step: the first moment over ``1 - b1``."""
        out = {}
        for name, p in self.params(names).items():
            state = self.opt.state.get(p, {})
            mu = state.get("mu", state.get("exp_avg"))
            out[name] = (math.inf if mu is None
                         else float(mu.double().norm()) / (1 - B1))
        return out


class FirstSteps:
    """Records the program's first ``steps`` steps from a ``solve``
    callback: each step's loss, the first gradient, and the parameters'
    change after the last of them, under the benchmark's leaf names."""

    def __init__(self, held: HeldOptimizer, prob, init: dict, steps: int):
        self.held = held
        self.names = list(prob.init_params)
        self.init = init
        self.steps = steps
        self.losses = []
        self.grad = {}
        self.change = {}

    def _ours(self, name: str) -> str:
        return name[len(problems.PREFIX):]

    def record(self, loss: float) -> bool:
        """Take step ``len(losses) + 1``'s reading; True once all are in."""
        self.losses.append(loss)
        if len(self.losses) == 1:
            self.grad = {self._ours(k): v for k, v in
                         self.held.first_gradient(self.names).items()}
        if len(self.losses) == self.steps:
            now = self.held.params(self.names)
            self.change = {
                self._ours(k): float((p.detach().double()
                                      - self.init[self._ours(k)].double())
                                     .norm())
                for k, p in now.items()}
            return True
        return False

    def readings(self) -> dict:
        return {"losses": list(self.losses), "grad": self.grad,
                "change": self.change}


def first_steps(npde, problem: dict, prob, init: dict, points_seed: int,
                steps: int, device) -> tuple:
    """The program's first ``steps`` steps of one ``solve`` of ``prob``, one
    step a block, as a cell's set-up takes them: (their readings, the
    solve's capture seconds)."""
    held = HeldOptimizer(npde, problem["optimizer"]["lr"])
    first = FirstSteps(held, prob, init, steps)
    generator = torch.Generator(device=device).manual_seed(points_seed)
    res = npde.solve(prob, held, maxiters=steps, inner_steps=1,
                     generator=generator,
                     callback=lambda it, loss, aux: first.record(loss)
                     and False)
    return first.readings(), res.aux.get("cuda_graph", {}).get(
        "capture_seconds")


class Tracer:
    """`torch.profiler` over one block of a ``solve`` of three blocks,
    driven by its callbacks: the first block holds the eager step and the
    capture, the second warms the profiler up (its first traced graph
    launch stalls the host), the third is traced, from the callback that
    ends the second to the one that ends it, after a synchronize."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile as prof

        self.device = device
        self.prof = prof(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=torch.profiler.schedule(
                             wait=0, warmup=1, active=1, repeat=1))
        self.seen = 0
        self.t_active = None
        self.window_s = None

    def __call__(self, it, loss, aux) -> bool:
        """The ``solve`` callback; True once the traced block has ended."""
        self.seen += 1
        if self.seen == 1:
            self.prof.start()
        elif self.seen == 2:
            self.prof.step()
            self.t_active = time.perf_counter()
        else:
            sync(self.device)
            self.window_s = time.perf_counter() - self.t_active
            self.prof.stop()
            return True
        return False

    def breakdown(self) -> dict:
        device, host = profile.split_events(self.prof.events())
        return profile.breakdown(device, host, self.window_s)


def traced_block(npde, prob, theta: dict, lr: float, steps: int, seed: int,
                 device) -> dict:
    """The breakdown of one traced block of ``steps`` steps of a fresh
    ``solve`` from ``theta`` (the window's parameters), whose captured
    step replays ``steps`` times a block with no host read in between.
    (The window reads each step's loss; under the profiler each launch
    of a large graph then stalls the host for milliseconds, which the
    untraced window does not pay.)"""
    tracer = Tracer(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    npde.solve(prob.with_params(theta), npde.adam(lr), maxiters=3 * steps,
               inner_steps=steps, generator=generator, callback=tracer)
    return tracer.breakdown()


def card_fields(count: int, device) -> dict:
    """The result's ``device`` object; on the CPU (tests only) a stand-in
    with no memory reading."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def power_line() -> str:
    """nvidia-smi's name and power limit of the cards, as it prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"

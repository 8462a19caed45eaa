"""The readings that set the limits of the Beltrami SPINN cell's comparison,
taken on the card at the cell's own size (no measured window).

    python3 benchmark/readings_beltrami.py --seeds S [S ...]
        [--workload spinn-beltrami-r64-g65] [--device cuda] [--overrides '{}']

For each seed, one JSON line each, with the three numbers of
`reference.compare` against the float64 reference:

* ``program``: the program's first steps as a run takes them in set-up;
* ``control``: the reference computed in TF32 (float32 with TF32 on), the
  precision below the configuration's;
* ``half``: the reference with the later half of the time nodes left out
  of the interior losses, the mean taken over the rest.

A step left unchanged reads 1 by ``change_gap`` and needs no run.  The
limits in ``workloads/<cell>.json`` lie between the program's largest
readings and the smallest of the others'.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

import harness  # noqa: E402
import problem_beltrami  # noqa: E402
import problems  # noqa: E402
import run  # noqa: E402
from reference import compare  # noqa: E402


def seed_readings(ctx) -> list:
    problem = problems.problem_of(ctx.config, ctx.workload)
    params_seed, points_seed = problems.seeds(ctx.seed, 2)
    steps = ctx.workload["check_steps"]
    init = problem_beltrami.init_params(problem, params_seed, ctx.device)

    def ref(dtype=torch.float64, **fault):
        return problem_beltrami.follow_reference(problem, init, steps, dtype,
                                                 **fault)

    prob = problem_beltrami.build(ctx.npde, problem, init, ctx.device)
    runs = {"program": harness.first_steps(ctx.npde, problem, prob, init,
                                           points_seed, steps,
                                           ctx.device)[0]}
    del prob
    harness.free(ctx.device)
    reference = ref()
    runs["control"] = ref(torch.float32, tf32=True)
    runs["half"] = ref(keep=2)
    return [{"seed": ctx.seed, "what": what,
             **compare.readings(got, reference)}
            for what, got in runs.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="spinn-beltrami-r64-g65")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}",
                    help="JSON laid over the files, as run.run_cell takes it")
    args = ap.parse_args(argv)
    cell = run.Cell(args.workload)
    npde = run.import_program()
    if args.device == "cuda":
        harness.log(f"cards: {harness.power_line()}")
    for seed in args.seeds:
        ctx = run.Context(cell, seed, 0, False, args.device, npde, 0.0,
                          json.loads(args.overrides))
        for line in seed_readings(ctx):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

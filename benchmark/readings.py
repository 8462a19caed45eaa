"""The readings that set the limits of a cell's comparison, taken on the
card at the cell's own size (no measured window).

    python3 benchmark/readings.py --workload NAME --seeds S [S ...]

For each seed, one JSON line each, with the three numbers of
`reference.compare` against the float64 reference:

* ``program``: the program's first steps as a run takes them in set-up
  (one-card cells; the four-card cell's come from its runs);
* ``control``: the reference computed in TF32 (float32 with TF32 on), the
  precision below the configuration's;
* ``half``: the reference with half of the batch left out, the mean taken
  over the rest (half the grid's rows on a separable configuration);
* ``share``: on a dense configuration, a rank's share of four with the
  exchange between ranks left out.

A step left unchanged reads 1 by ``change_gap`` and needs no run.  The
limits in ``workloads/NAME.json`` lie between the program's largest
readings and the smallest of the control's.
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
import problems  # noqa: E402
import run  # noqa: E402
from reference import compare  # noqa: E402


def tf32(fn):
    """``fn()`` with TF32 matrix products."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return fn()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def seed_readings(ctx, with_program: bool) -> list:
    problem = problems.problem_of(ctx.config, ctx.workload)
    params_seed, points_seed = problems.seeds(ctx.seed, 2)
    steps = ctx.workload["check_steps"]
    init = problems.init_params(problem, params_seed, ctx.device)

    def ref(dtype=torch.float64, **fault):
        return problems.follow_reference(problem, init, points_seed, steps,
                                         dtype, **fault)

    runs = {}
    if with_program:
        prob = problems.build(ctx.npde, problem, init, ctx.device)
        runs["program"] = harness.first_steps(ctx.npde, problem, prob, init,
                                              points_seed, steps,
                                              ctx.device)[0]
        del prob
        harness.free(ctx.device)
    reference = ref()
    runs["control"] = tf32(lambda: ref(torch.float32))
    runs["half"] = ref(keep=2)
    if problem["trial_function"] != "separable":
        runs["share"] = ref(keep=4, mean_of_kept=False)
    return [{"seed": ctx.seed, "what": what,
             **compare.readings(got, reference)}
            for what, got in runs.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}",
                    help="JSON laid over the files, as run.run_cell takes it")
    args = ap.parse_args(argv)
    cell = run.Cell(args.workload)
    npde = run.import_program()
    if args.device == "cuda":
        harness.log(f"cards: {harness.power_line()}")
    with_program = cell.chips == 1
    for seed in args.seeds:
        ctx = run.Context(cell, seed, 0, False, args.device, npde, 0.0,
                          json.loads(args.overrides))
        for line in seed_readings(ctx, with_program):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The comparison that decides ``correct`` for a training cell.

The program's first steps and the reference's are compared by three
numbers, each against its limit from the cell's workload file:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient (the program's as its optimizer holds it after one step);
* ``change_gap``: the worst leaf's gap between the norms of the
  parameters' change over the steps.

A leaf's gap is ``|program - reference|`` over the reference's norm of that
leaf or the median leaf's, whichever is larger.  Leaves whose reference
gradient is under a thousandth of the median leaf's move under Adam by
round-off alone and are left out of ``change_gap``.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "change_gap")
STILL = 1e-3        # a leaf's gradient under this share of the median's


def _leaf_gap(program: dict, reference: dict, leaves) -> float:
    floor = statistics.median(reference[k] for k in reference)
    worst = 0.0
    for k in leaves:
        if k not in program or not math.isfinite(program[k]):
            return math.inf
        worst = max(worst, abs(program[k] - reference[k])
                    / max(reference[k], floor))
    return worst


def readings(program: dict, reference: dict) -> dict:
    """``{name: value}`` for `NAMES`; ``program`` and ``reference`` as
    `reference.dense.follow` returns them (a missing or non-finite entry
    of the program's reads infinity)."""
    ref_losses, losses = reference["losses"], program.get("losses", [])
    if len(losses) != len(ref_losses) or not all(map(math.isfinite, losses)):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grad = reference["grad"]
    floor = statistics.median(grad.values())
    moving = [k for k, v in grad.items() if v >= STILL * floor]
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(program.get("grad", {}), grad, grad),
        "change_gap": _leaf_gap(program.get("change", {}),
                                {k: reference["change"][k] for k in moving},
                                moving),
    }


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and within its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks

#!/usr/bin/env python3
"""ms a replayed step of the PyTorch port's Navier-Stokes vorticity operator
(`chip_smoke.py` phase 29's configuration: FNO3D w16 m(8,8,4) d3 out 2,
33^2 x 9 grid, 12 GRF ICs, Adam 2e-3, float32, TF32 off) for several
checkouts of the repository, each in a fresh process, in the order given:

    python3 scripts/torch_ns_step_turns.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (for example one unpacked by `git
archive`); its own `chip_smoke.py` and `neuralpde_tpu_torch` are used.  The
step time is taken over the steps after the first block (which holds the
eager step and the capture).  Needs a CUDA card.
"""

import subprocess
import sys

STEPS = 2000
BLOCK = 50

_RUN = f"""
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
import neuralpde_tpu_torch as npde
torch.backends.cuda.matmul.allow_tf32 = False
system, alg = chip_smoke._ns_alg(npde)
stamps = []
npde.solve_pino_pde(system, alg, maxiters={STEPS}, inner_steps={BLOCK},
                    abstol=0.0, callback=lambda it, loss, aux:
                    stamps.append((it, time.perf_counter())))
n = stamps[-1][0] - stamps[0][0]
print(1e3 * (stamps[-1][1] - stamps[0][1]) / n)
"""


def main() -> int:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, "-c", _RUN, tree],
                             capture_output=True, text=True, check=True)
        ms = float(out.stdout.strip().splitlines()[-1])
        print(f"{tree}: {ms:.4f} ms a step ({STEPS} steps, blocks of "
              f"{BLOCK})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

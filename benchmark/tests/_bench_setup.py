"""Paths and small sizes for the benchmark's tests (CPU)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

# each cell at a size the CPU runs in seconds
SMALL = {
    "dense-w64-b2m": {"config": {"sampling": {
        "kind": "StochasticTraining", "points": 2048, "bcs_points": 256,
        "microbatch": 512}}},
    "spinn-r64-g16384": {"config": {"grid": 64}},
    "dense-w64-hard-to-target": {"workload": {
        "problem": {"hard_box": True, "sampling": {
            "kind": "StochasticTraining", "points": 256, "bcs_points": 32,
            "microbatch": None}, "optimizer": {"lr": 0.002}},
        "chunk_steps": 50, "block_steps": 10, "warmup_steps": 20,
        "target_rms": 0.02, "pool": 4, "trial_cap_s": 2}},
    "dense-w64-b2m-dp4": {"config": {"sampling": {
        "kind": "StochasticTraining", "points": 2048, "bcs_points": 256,
        "microbatch": 512}}, "workload": {"ranks": 2,
                                          "calibration_steps": 3}},
}

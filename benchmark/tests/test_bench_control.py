"""The control fails the comparison: the reference computed in TF32 (the
precision below the configurations' float32 with TF32 off), put in the
program's place, against the float64 reference, on three seeds of each
configuration at a size a test run holds.  Needs the card (TF32 exists
only there)."""

import json
import os

import _bench_setup as setup

import pytest
import torch

import problems
from reference import compare

SIZES = {"dense-w64-b2m": {"sampling": {"points": 65536, "bcs_points": 8192,
                                        "microbatch": 32768}},
         "spinn-r64-g16384": {"grid": 2048},
         "dense-w64-hard-to-target": {}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 runs only there")
    return torch.device("cuda")


def _tf32(fn):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_tf32_control_is_not_correct(cuda, name):
    with open(os.path.join(setup.BENCH, "workloads", f"{name}.json")) as f:
        workload = json.load(f)
    spec = json.load(open(os.path.join(setup.ROOT, "BENCHMARK.json")))
    entry = next(w for w in spec["workloads"] if w["name"] == name)
    config_file = next(c["file"] for c in spec["configs"]
                       if c["name"] == entry["config"])
    with open(os.path.join(setup.ROOT, config_file)) as f:
        config = json.load(f)
    problem = {**problems.problem_of(config, workload), **SIZES[name]}
    for seed in (1, 2, 3):
        params_seed, points_seed = problems.seeds(seed, 2)
        init = problems.init_params(problem, params_seed, cuda)
        steps = workload["check_steps"]
        want = problems.follow_reference(problem, init, points_seed, steps,
                                         torch.float64)
        got = _tf32(lambda: problems.follow_reference(
            problem, init, points_seed, steps, torch.float32))
        correct, checks = compare.judge(compare.readings(got, want),
                                        workload["limits"])
        assert not correct, (seed, checks)

"""The FLOP and byte counts against hand arithmetic."""

import json
import os

import _bench_setup

import problems
from reference import flops


def test_layer_flops_of_w64():
    # 2*(2*64 + 64*64 + 64*1)
    assert flops.layer_flops([2, 64, 64, 1]) == 8576


def test_dense_step_flops_at_bench_batch():
    interior, boundary = 2_097_152, 4 * 262_144
    want = 3 * 8576 * (5 * interior + boundary)
    assert flops.dense_step_flops([2, 64, 64, 1], interior, boundary) == want
    assert want == 296_755_396_608


def test_separable_step_flops_at_16384_rank_64():
    n, r = 16_384, 64
    axis = 2 * (64 + 64 * 64 + 64 * 64)            # one column, one axis net
    want = 2 * n * 3 * 3 * axis + 12 * n * n * r
    assert flops.separable_step_flops([1, 64, 64, 64], r, n) == want


def test_tanh_jet2_bytes():
    assert flops.tanh_jet2_bytes(64 * 32768, 4, "forward") == 6 * 64 * 32768 * 4
    assert flops.tanh_jet2_bytes(10, 8, "backward") == 9 * 10 * 8


def _config(name):
    with open(os.path.join(_bench_setup.BENCH, "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def test_counted_points_are_bench_s():
    dense = _config("dense-poisson-w64")
    assert problems.counted_points(dense) == 2_097_152 + 4 * 262_144
    assert problems.counted_points(_config("spinn-poisson-r64")) == 16_384 ** 2


def test_model_flops_follow_the_configurations():
    dense = _config("dense-poisson-w64")
    assert problems.model_flops(dense) == flops.dense_step_flops(
        [2, 64, 64, 1], 2_097_152, 4 * 262_144)
    spinn = _config("spinn-poisson-r64")
    assert problems.model_flops(spinn) == flops.separable_step_flops(
        [1, 64, 64, 64], 64, 16_384)

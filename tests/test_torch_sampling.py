"""The port's samplers (`neuralpde_tpu_torch.ops.sampling`, its native
Sobol engine) against `neuralpde_tpu.ops.sampling` and `neuralpde_tpu.native`.

Bit designs are compared bit for bit; the mapping of shifted bits to
[0, 1) is float32 on both sides and must agree exactly.  The inverse-CDF
categorical draw follows its weights by a chi-square test at p = 0.001
(the draw is seeded, so the test is deterministic).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralpde_tpu.ops import sampling as jsampling
from neuralpde_tpu_torch.ops import sampling


@pytest.mark.parametrize("dim", [1, 2, 5, 21])
def test_sobol_and_lattice_bits_match_jax(dim):
    for fn in ("sobol_bits", "lattice_rule_bits"):
        got = getattr(sampling, fn)(257, dim)
        want = getattr(jsampling, fn)(257, dim)
        assert got.dtype == np.uint32 and got.shape == (dim, 257)
        np.testing.assert_array_equal(got, want)


def test_sobol_beyond_the_table_uses_the_ports_own_engine():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native Sobol engine")
    from neuralpde_tpu import native as jnative
    from neuralpde_tpu_torch import native

    assert native.available()
    with open(jnative._SRC) as f:
        assert native.SOURCE.read_text() == f.read()
    got = sampling.sobol_bits(300, 25)
    np.testing.assert_array_equal(got, jnative.sobol_bits_native(300, 25))


def test_randomize_bits_and_bits_to_unit_match_jax_with_an_injected_shift():
    base = jsampling.sobol_bits(64, 3)
    shift = np.asarray(jax.random.bits(jax.random.key(4), (3, 1),
                                       dtype=jnp.uint32))
    want = np.asarray(jsampling.bits_to_unit(jnp.asarray(base) ^ shift))
    bits = sampling.bits_tensor(base)
    got = sampling.bits_to_unit(sampling.randomize_bits(
        bits, shift=torch.tensor(shift.astype(np.int64))))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)

    lb, ub = np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 2.5])
    jpts = np.asarray(jsampling.sobol_sample(base, jnp.asarray(lb),
                                             jnp.asarray(ub),
                                             key=jax.random.key(4),
                                             dtype=jnp.float64))
    tpts = sampling.sobol_sample(base, torch.tensor(lb), torch.tensor(ub),
                                 shift=torch.tensor(shift.astype(np.int64)))
    np.testing.assert_array_equal(tpts.numpy(), jpts)
    # a drawn shift is one 32-bit word per dimension, the same for every point
    drawn = sampling.randomize_bits(torch.zeros((3, 5), dtype=torch.int64),
                                    torch.Generator().manual_seed(0))
    assert bool((drawn == drawn[:, :1]).all()) and int(drawn.min()) >= 0
    assert int(drawn.max()) < 2 ** 32


def test_latin_hypercube_hits_each_stratum_once_per_dimension():
    n = 97
    lb = torch.tensor([0.0, -2.0, 1.0], dtype=torch.float64)
    ub = torch.tensor([1.0, 2.0, 1.5], dtype=torch.float64)
    pts = sampling.latin_hypercube(n, lb, ub, torch.Generator().manual_seed(1))
    assert pts.shape == (3, n) and pts.dtype == torch.float64
    u = (pts - lb[:, None]) / (ub - lb)[:, None]
    for row in u:
        strata = torch.floor(row * n).long()
        assert sorted(strata.tolist()) == list(range(n))


def test_categorical_inverse_cdf_follows_the_weights():
    w = torch.tensor([1.0, 0.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    n = 40_000
    idx = sampling.categorical(w, n, torch.Generator().manual_seed(2))
    counts = np.bincount(idx.numpy(), minlength=5)
    assert counts[1] == 0
    p = (w / w.sum()).numpy()
    keep = p > 0
    chi2 = float(np.sum((counts[keep] - n * p[keep]) ** 2 / (n * p[keep])))
    assert chi2 < 16.27    # 3 degrees of freedom, p = 0.001

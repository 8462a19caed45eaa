"""Collocation-point samplers (`neuralpde_tpu.ops.sampling`).

Static designs (the Sobol base sequence and the lattice rule) are host
numpy precomputes; everything drawn per step is a function of a
`torch.Generator` on the tensors' device, so a training step that samples
can be captured as a CUDA graph and replayed with fresh draws.

Bit patterns are carried as ``int64`` holding values in ``[0, 2^32)``:
torch has no unsigned 32-bit arithmetic on every op, and XOR and shifts of
non-negative int64 values give the uint32 results of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

# Joe-Kuo "new-joe-kuo-6" primitive polynomials & initial direction numbers
# for Sobol dimensions 2..21 (dimension 1 is the van der Corput sequence).
# Format: (s, a, [m_1..m_s]).  Public-domain table of S. Joe & F. Y. Kuo.
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
    (5, 11, [1, 1, 5, 1, 1]),
    (5, 13, [1, 1, 1, 3, 11]),
    (5, 14, [1, 3, 5, 5, 31]),
    (6, 1, [1, 3, 3, 9, 7, 49]),
    (6, 13, [1, 1, 1, 15, 21, 21]),
    (6, 16, [1, 3, 1, 13, 27, 49]),
    (6, 19, [1, 1, 1, 15, 7, 5]),
    (6, 22, [1, 3, 1, 15, 13, 25]),
    (6, 25, [1, 1, 5, 5, 19, 61]),
    (7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (7, 4, [1, 3, 7, 13, 13, 15, 69]),
]

_NBITS = 32
MAX_SOBOL_DIM = len(_JOE_KUO) + 1


def _direction_numbers(dim: int) -> np.ndarray:
    """v[j, k] direction numbers (as uint64 shifted to 32-bit fixed point)."""
    v = np.zeros((dim, _NBITS), dtype=np.uint64)
    for k in range(_NBITS):        # dimension 0: van der Corput
        v[0, k] = np.uint64(1) << np.uint64(_NBITS - 1 - k)
    for j in range(1, dim):
        s, a, m = _JOE_KUO[j - 1]
        for k in range(_NBITS):
            if k < s:
                v[j, k] = np.uint64(m[k]) << np.uint64(_NBITS - 1 - k)
            else:
                val = v[j, k - s] ^ (v[j, k - s] >> np.uint64(s))
                for i in range(1, s):
                    if (a >> (s - 1 - i)) & 1:
                        val ^= v[j, k - i]
                v[j, k] = val
    return v


def sobol_bits(points: int, dim: int) -> np.ndarray:
    """First ``points`` Sobol points as uint32 bit patterns, shape
    (dim, points): a host precompute (Gray-code construction).  Dimensions
    beyond the embedded Joe-Kuo table go to the port's native engine
    (`neuralpde_tpu_torch.native`)."""
    if dim > MAX_SOBOL_DIM:
        from .. import native

        if native.available():
            return native.sobol_bits_native(points, dim)
        raise ValueError(
            f"pure-Python Sobol supports up to {MAX_SOBOL_DIM} dims (got "
            f"{dim}) and the native engine is unavailable; use 'lhs' or "
            "'random' sampling")
    v = _direction_numbers(dim)
    out = np.zeros((dim, points), dtype=np.uint64)
    x = np.zeros(dim, dtype=np.uint64)
    for i in range(1, points):
        c = (~np.uint64(i - 1) & np.uint64(i)).item().bit_length() - 1
        x ^= v[:, c]
        out[:, i] = x
    return out.astype(np.uint32)


def lattice_rule_bits(points: int, dim: int) -> np.ndarray:
    """Rank-1 lattice (Kronecker construction, alpha_j = frac(sqrt(p_j))
    for distinct primes) in 32-bit fixed point, shape (dim, points); the
    first dimension is the regular grid i/n."""
    primes = []
    c = 2
    while len(primes) < dim:
        if all(c % q for q in primes):
            primes.append(c)
        c += 1
    alpha = np.sqrt(np.asarray(primes, dtype=np.float64)) % 1.0
    i = np.arange(points, dtype=np.float64)
    mat = np.empty((dim, points), dtype=np.float64)
    mat[0] = i / points
    for j in range(1, dim):
        mat[j] = (i * alpha[j - 1]) % 1.0
    return (mat * 2.0**32).astype(np.uint32)


def bits_tensor(bits, device=None) -> torch.Tensor:
    """uint32 bit patterns (numpy) as an int64 tensor on ``device``; a
    tensor passes through."""
    if isinstance(bits, torch.Tensor):
        return bits.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(bits).astype(np.int64), device=device)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Bit patterns in [0, 2^32) (int64) -> float32 in [0, 1): the top 24
    bits times 2^-24, as `neuralpde_tpu.ops.sampling.bits_to_unit`."""
    return (bits >> 8).to(torch.float32) * 2.0**-24


def randomize_bits(bits: torch.Tensor, generator: torch.Generator | None = None,
                   *, shift: torch.Tensor | None = None) -> torch.Tensor:
    """Random digital shift (XOR scramble) with one uniform 32-bit word per
    dimension, drawn from ``generator`` unless ``shift`` (dim, 1) is given."""
    if shift is None:
        shift = torch.randint(0, 2**32, (bits.shape[0], 1), generator=generator,
                              dtype=torch.int64, device=bits.device)
    return bits ^ shift


def sobol_sample(base_bits, lb, ub, generator=None, dtype=None, *,
                 shift=None) -> torch.Tensor:
    """Map Sobol (or lattice) bits into the box [lb, ub], shape (dim, n),
    on the device of ``lb``; randomized by a digital shift when a
    ``generator`` or a ``shift`` is given.  ``base_bits`` is the uint32
    numpy design or, to copy nothing from the host per call, its int64
    tensor on the device (`bits_tensor`)."""
    lb = torch.as_tensor(lb, dtype=dtype)
    ub = torch.as_tensor(ub, dtype=lb.dtype, device=lb.device)
    bits = bits_tensor(base_bits, lb.device)
    if generator is not None or shift is not None:
        bits = randomize_bits(bits, generator, shift=shift)
    u = bits_to_unit(bits).to(lb.dtype)
    return u * (ub[:, None] - lb[:, None]) + lb[:, None]


def latin_hypercube(points: int, lb, ub, generator: torch.Generator, *,
                    dtype=None) -> torch.Tensor:
    """Latin-hypercube sample in [lb, ub], shape (dim, points), on the
    device of ``lb``: per dimension a random permutation of the ``points``
    strata plus a uniform jitter inside each."""
    lb = torch.as_tensor(lb, dtype=dtype)
    ub = torch.as_tensor(ub, dtype=lb.dtype, device=lb.device)
    dim = lb.shape[0]
    perms = torch.stack([torch.randperm(points, generator=generator,
                                        device=lb.device)
                         for _ in range(dim)])
    jitter = torch.rand((dim, points), generator=generator, dtype=lb.dtype,
                        device=lb.device)
    u = (perms.to(lb.dtype) + jitter) / points
    return u * (ub[:, None] - lb[:, None]) + lb[:, None]


def uniform_random(points: int, lb, ub, generator: torch.Generator, *,
                   dtype=None, device=None) -> torch.Tensor:
    """Uniform random points in [lb, ub], shape (dim, points), drawn from
    ``generator`` on ``device`` (default: that of ``lb``).

    Mirrors ``generate_random_points`` (reference:
    src/training_strategies.jl:197-200).
    """
    lb = torch.as_tensor(lb, dtype=dtype, device=device)
    ub = torch.as_tensor(ub, dtype=lb.dtype, device=lb.device)
    u = torch.rand((lb.shape[0], points), generator=generator, dtype=lb.dtype,
                   device=lb.device)
    return u * (ub[:, None] - lb[:, None]) + lb[:, None]


def uniform_nodes(points: int, lb: torch.Tensor, ub: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """``points`` uniform nodes in [lb, ub] for one grid axis, shape
    (points,), on the device and in the dtype of the 0-d tensor ``lb``."""
    return lb + (ub - lb) * torch.rand((points,), generator=generator,
                                       dtype=lb.dtype, device=lb.device)


def categorical(weights: torch.Tensor, n: int,
                generator: torch.Generator) -> torch.Tensor:
    """``n`` indices drawn with probability proportional to the non-negative
    ``weights`` (1-D), by inverse CDF: a search of ``n`` uniforms in the
    cumulative sum.  The law of `jax.random.categorical` over ``log
    weights``, not its draws."""
    cdf = torch.cumsum(weights, dim=0)
    u = torch.rand((n,), generator=generator, dtype=cdf.dtype,
                   device=cdf.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=weights.shape[0] - 1)

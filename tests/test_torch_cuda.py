"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 rtol 1e-5, atol 1e-6 (`tanhf` and torch's tanh differ by
a few ulp, and s = 1 - a^2 cancels for large |z|); float64 1e-12.
"""

import numpy as np
import pytest
import torch

from neuralpde_tpu_torch.kernels import tanh_jet as tj

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(scale=2.0, size=shape), dtype=dtype,
                         device=device) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(64, 4099), (3, 5)], ids=str)
def test_tanh_jet2_kernel_matches_plain(cuda, dtype, shape):
    zs = [t.requires_grad_(True) for t in _inputs(shape, dtype, cuda)]
    before = tj.tanh_jet2.launches
    out = tj.tanh_jet2(*zs)
    cot = [torch.randn_like(o) for o in out]
    grads = torch.autograd.grad(out, zs, cot)
    torch.cuda.synchronize()
    assert tj.tanh_jet2.launches == before + 2
    plain = tj.tanh_jet2_reference(*(t.detach() for t in zs))
    plain_g = tj.tanh_jet2_backward_reference(*(t.detach() for t in zs), *cot)
    for g, w in zip(list(out) + list(grads), list(plain) + list(plain_g)):
        torch.testing.assert_close(g.detach(), w, **TOL[dtype])


@pytest.mark.cuda
def test_tanh_jet2_kernel_rejects_what_it_does_not_take(cuda):
    z, z1, z2 = _inputs((8, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tj.tanh_jet2_forward_cuda(z.t(), z1.t(), z2.t())
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        tj.tanh_jet2_forward_cuda(z, z1.double(), z2)
    with pytest.raises(ValueError, match="unsupported"):
        tj.tanh_jet2_forward_cuda(z.half(), z1.half(), z2.half())

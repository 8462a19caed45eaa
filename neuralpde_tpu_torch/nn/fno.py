"""Fourier Neural Operators (`neuralpde_tpu.nn.fno`; Li et al. 2021, beyond
the reference, whose PINOODE trains DeepONet/MLP operators only).

Each layer applies a per-mode complex channel mixing to the lowest rFFT
coefficients along the grid axes plus a pointwise linear bypass.  FFTs are
`torch.fft` (cuFFT on the card); the mixing is a complex `torch.einsum`.

Layout as in the JAX package (features leading, family trailing): fields
are ``(channels, *grid, P)``.  Spectral weights are two real parameters a
block, ``w_re`` and ``w_im`` (``w{b}_re``/``w{b}_im`` in 2-D and 3-D), as
the JAX package stores them, and are formed into a complex tensor in
``forward``: Adam then keeps its moments per real component, as optax does
on the JAX package's real leaves.

The inverse transform runs in one fixed order on every backend: a
complex-to-complex inverse over the leading grid axes, then a
complex-to-real inverse over the last, which reads only the real part of
its zero (and, for an even size, Nyquist) bin.  That is what the CPU
transforms of both packages do with a spectrum that is not Hermitian (the
mixed spectrum is not: its zero bin has an imaginary part), and what a
multi-dimensional complex-to-real cuFFT leaves undefined.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import default_float
from .core import Chain, Dense, Module, gelu


def _pointwise(layer, x):
    """Apply a Dense/Chain per grid point: (C, *grid, P) -> (C', *grid, P),
    contracting the channel axis."""
    if isinstance(layer, Chain):
        for sub in layer.layers:
            x = _pointwise(sub, x)
        return x
    y = torch.tensordot(layer.weight, x, dims=([1], [0]))
    if layer.bias is not None:
        y = y + layer.bias.reshape((-1,) + (1,) * (x.ndim - 1))
    return layer.activation(y)


def _irfft_grid(yf, sizes, axes):
    """Inverse of ``torch.fft.rfftn(x, dim=axes)`` for a spectrum that need
    not be Hermitian: c2c inverses over ``axes[:-1]``, then c2r over
    ``axes[-1]`` taking only the real part of its zero and Nyquist bins."""
    if len(axes) > 1:
        yf = torch.fft.ifftn(yf, dim=axes[:-1])
    dim, n = axes[-1], sizes[-1]
    nf = yf.shape[dim]
    parts = [yf.narrow(dim, 0, 1).real.to(yf.dtype)]
    if n % 2 == 0 and nf > 1:
        parts += [yf.narrow(dim, 1, nf - 2),
                  yf.narrow(dim, nf - 1, 1).real.to(yf.dtype)]
    elif nf > 1:
        parts.append(yf.narrow(dim, 1, nf - 1))
    return torch.fft.irfft(torch.cat(parts, dim=dim), n=n, dim=dim)


def _uniform(generator, shape, scale, like):
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return scale * (2 * u - 1)


class _Spectral(Module):
    """Shared parameter handling of the spectral layers: real/imaginary
    weight blocks ``(*modes, in, out)`` drawn centered uniform with scale
    ``1/(in·out)`` (Li et al.'s reference scale)."""

    def __init__(self, in_channels, out_channels, modes, names):
        super().__init__()
        self._in = in_channels
        self._out = out_channels
        self.modes = modes
        self._names = names
        shape = (*modes, in_channels, out_channels)
        for name in names:
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=default_float())))
        self.reset_parameters()

    @property
    def in_dim(self):
        return self._in

    @property
    def out_dim(self):
        return self._out

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        scale = 1.0 / (self._in * self._out)
        for name in self._names:
            w = getattr(self, name)
            w.copy_(_uniform(generator, tuple(w.shape), scale, w))

    def _weight(self, b, index, dtype):
        """Complex block ``b`` ("" in 1-D) cut to ``index``."""
        re, im = getattr(self, f"w{b}_re"), getattr(self, f"w{b}_im")
        return torch.complex(re[index].to(dtype), im[index].to(dtype))


class SpectralConv1D(_Spectral):
    """Keep the lowest `modes` rFFT coefficients along axis 1, mix channels
    with one complex (in, out) matrix per kept mode, truncate the rest.
    Input and output ``(channels, T, P)``."""

    def __init__(self, in_channels: int, out_channels: int, modes: int):
        super().__init__(in_channels, out_channels, (int(modes),),
                         ("w_re", "w_im"))

    def forward(self, x):
        t = x.shape[1]
        xf = torch.fft.rfft(x, dim=1)                     # (C_in, F, P)
        nf = xf.shape[1]
        m = min(self.modes[0], nf)
        w = self._weight("", slice(0, m), x.dtype)
        yf = xf.new_zeros((self._out, nf, xf.shape[2]))
        yf[:, :m] = torch.einsum("imp,mio->omp", xf[:, :m], w)
        return _irfft_grid(yf, (t,), (1,))


class SpectralConv2D(_Spectral):
    """2-D channel mixing for fields ``(channels, X, T, P)``: rFFT2 over the
    grid axes, keep the first ``modes[1]`` coefficients along the last axis
    crossed with the first/last ``modes[0]`` rows along the first (the
    FNO-2D corner blocks), mix channels per kept mode pair.  Two complex
    blocks ``(modes_x, modes_t, in, out)``; mode counts are clipped so the
    two x blocks never overlap on small grids."""

    def __init__(self, in_channels: int, out_channels: int, modes):
        mx, mt = (modes, modes) if isinstance(modes, int) else tuple(modes)
        super().__init__(in_channels, out_channels, (int(mx), int(mt)),
                         ("w1_re", "w1_im", "w2_re", "w2_im"))

    def forward(self, x):
        _, nx, nt, p = x.shape
        xf = torch.fft.rfft2(x, dim=(1, 2))               # (C, X, F, P)
        nf = xf.shape[2]
        mt = min(self.modes[1], nf)
        mx_pos = min(self.modes[0], (nx + 1) // 2)
        mx_neg = min(self.modes[0], nx // 2)
        yf = xf.new_zeros((self._out, nx, nf, p))
        w1 = self._weight(1, (slice(0, mx_pos), slice(0, mt)), x.dtype)
        yf[:, :mx_pos, :mt] = torch.einsum(
            "ixtp,xtio->oxtp", xf[:, :mx_pos, :mt], w1)
        if mx_neg > 0:
            w2 = self._weight(2, (slice(0, mx_neg), slice(0, mt)), x.dtype)
            yf[:, nx - mx_neg:, :mt] = torch.einsum(
                "ixtp,xtio->oxtp", xf[:, nx - mx_neg:, :mt], w2)
        return _irfft_grid(yf, (nx, nt), (1, 2))


class SpectralConv3D(_Spectral):
    """3-D channel mixing for fields ``(channels, N1, N2, N3, P)``: rFFTn
    over the grid axes, keep the first ``modes[2]`` coefficients along the
    last axis crossed with the positive/negative frequency rows along the
    two full axes (four corner blocks), mix channels per kept mode triple.
    Four complex blocks ``(m1, m2, m3, in, out)``; mode counts are clipped
    so sign blocks never overlap on small grids."""

    def __init__(self, in_channels: int, out_channels: int, modes):
        m = (modes,) * 3 if isinstance(modes, int) else tuple(modes)
        super().__init__(in_channels, out_channels, tuple(int(v) for v in m),
                         tuple(f"w{b}_{c}" for b in range(4)
                               for c in ("re", "im")))

    def forward(self, x):
        _, n1, n2, n3, p = x.shape
        xf = torch.fft.rfftn(x, dim=(1, 2, 3))            # (C, N1, N2, F, P)
        nf = xf.shape[3]
        m3 = min(self.modes[2], nf)
        pos1 = min(self.modes[0], (n1 + 1) // 2)
        neg1 = min(self.modes[0], n1 // 2)
        pos2 = min(self.modes[1], (n2 + 1) // 2)
        neg2 = min(self.modes[1], n2 // 2)
        # the 4 sign corners along the two full axes, (slice, kept) pairs
        ax1 = ((slice(0, pos1), pos1), (slice(n1 - neg1, n1), neg1))
        ax2 = ((slice(0, pos2), pos2), (slice(n2 - neg2, n2), neg2))
        yf = xf.new_zeros((self._out, n1, n2, nf, p))
        for b, ((s1, k1), (s2, k2)) in enumerate(
                (i, j) for i in ax1 for j in ax2):
            if k1 == 0 or k2 == 0:
                continue
            w = self._weight(b, (slice(0, k1), slice(0, k2), slice(0, m3)),
                             x.dtype)
            yf[:, s1, s2, :m3] = torch.einsum(
                "ixyzp,xyzio->oxyzp", xf[:, s1, s2, :m3], w)
        return _irfft_grid(yf, (n1, n2, n3), (1, 2, 3))


class _FNO(Module):
    """Pointwise lift -> ``depth`` × ``act(spectral + pointwise bypass)``
    (no activation after the last block) -> two-layer pointwise
    projection, with the grid coordinates appended as input channels."""

    def __init__(self, in_channels, width, modes, depth, out_channels,
                 activation, ndim, spectral):
        super().__init__()
        self._in = in_channels
        self.width = width
        self.modes = modes
        self.depth = depth
        self._out = out_channels
        self.activation = activation
        self.ndim = ndim
        self.lift = Dense(in_channels + ndim, width)
        self.proj = Chain(Dense(width, width, activation),
                          Dense(width, out_channels))
        for i in range(depth):
            self.add_module(f"spectral_{i}", spectral(width, width, modes))
            self.add_module(f"bypass_{i}", Dense(width, width))

    @property
    def in_dim(self):
        return self._in

    @property
    def out_dim(self):
        return self._out

    def reset_parameters(self, generator=None):
        self.lift.reset_parameters(generator)
        self.proj.reset_parameters(generator)
        for i in range(self.depth):
            getattr(self, f"spectral_{i}").reset_parameters(generator)
            getattr(self, f"bypass_{i}").reset_parameters(generator)

    def _run(self, p, gs):
        """``p`` (C, P) or (C, *grid, P); ``gs`` the 1-D grid tensors."""
        ns = tuple(g.shape[0] for g in gs)
        if p.ndim == 2:
            field = p.reshape((p.shape[0],) + (1,) * self.ndim
                              + (p.shape[1],)).expand(
                (p.shape[0], *ns, p.shape[1]))
        elif p.ndim == self.ndim + 2:
            field = p
        else:
            raise ValueError(self._layout_error(p.ndim))
        n_p = field.shape[-1]
        coord = [g.to(field.dtype).reshape(
            (1,) + tuple(n if a == i else 1 for i, n in enumerate(ns))
            + (1,)).expand((1, *ns, n_p)) for a, g in enumerate(gs)]
        v = _pointwise(self.lift, torch.cat([field, *coord], dim=0))
        for i in range(self.depth):
            y = (getattr(self, f"spectral_{i}")(v)
                 + _pointwise(getattr(self, f"bypass_{i}"), v))
            v = self.activation(y) if i < self.depth - 1 else y
        out = _pointwise(self.proj, v)
        return out[0] if self._out == 1 else out


def _grid_tensors(grids, like):
    return [torch.as_tensor(g, dtype=like.dtype, device=like.device)
            .reshape(-1) for g in grids]


class FNO1D(_FNO):
    """1-D FNO over a uniform time grid, with `DeepONet`'s calling
    convention: ``forward((p, t))`` with ``p`` the parameter columns
    ``(in_channels, P)`` (constant channels over the grid) or a field
    ``(in_channels, T, P)``, and ``t`` the uniform grid ``(1, T)``, appended
    as a coordinate channel.  Returns ``(T, P)`` when ``out_channels == 1``,
    else ``(out_channels, T, P)``."""

    def __init__(self, in_channels: int, width: int = 32, modes: int = 16,
                 depth: int = 4, out_channels: int = 1, activation=gelu):
        super().__init__(in_channels, width, modes, depth, out_channels,
                         activation, 1,
                         lambda i, o, m: SpectralConv1D(i, o, m))

    def _layout_error(self, ndim):
        return ("FNO1D input p must be (in_channels, P) or "
                f"(in_channels, T, P); got ndim={ndim}")

    def forward(self, x):
        p, t = x
        return self._run(p, _grid_tensors([t[0]], p))


class FNO2D(_FNO):
    """2-D FNO over a uniform tensor grid (a `solve_pino_pde` backbone):
    ``forward((p, (x, t)))`` with ``p`` ``(in_channels, P)`` or a field
    ``(in_channels, X, T, P)``.  Returns ``(X, T, P)`` when ``out_channels
    == 1``, else ``(out_channels, X, T, P)``."""

    def __init__(self, in_channels: int, width: int = 32, modes=12,
                 depth: int = 4, out_channels: int = 1, activation=gelu):
        mx, mt = (modes, modes) if isinstance(modes, int) else tuple(modes)
        super().__init__(in_channels, width, (int(mx), int(mt)), depth,
                         out_channels, activation, 2, SpectralConv2D)

    def _layout_error(self, ndim):
        return ("FNO2D input p must be (in_channels, P) or "
                f"(in_channels, X, T, P); got ndim={ndim}")

    def forward(self, x):
        p, grids = x
        return self._run(p, _grid_tensors(grids[:2], p))


class FNO3D(_FNO):
    """3-D FNO over a uniform tensor grid (a `solve_pino_pde` backbone for
    three independent variables, e.g. 2-D + time): ``forward((p, (g1, g2,
    g3)))`` with ``p`` ``(in_channels, P)`` or a field ``(in_channels, N1,
    N2, N3, P)``.  Returns ``(N1, N2, N3, P)`` when ``out_channels == 1``,
    else ``(out_channels, N1, N2, N3, P)``."""

    def __init__(self, in_channels: int, width: int = 24, modes=8,
                 depth: int = 4, out_channels: int = 1, activation=gelu):
        m = (modes,) * 3 if isinstance(modes, int) else tuple(modes)
        super().__init__(in_channels, width, tuple(int(v) for v in m), depth,
                         out_channels, activation, 3, SpectralConv3D)

    def _layout_error(self, ndim):
        return ("FNO3D input p must be (in_channels, P) or "
                f"(in_channels, N1, N2, N3, P); got ndim={ndim}")

    def forward(self, x):
        p, grids = x
        return self._run(p, _grid_tensors(grids, p))

"""Serving export (`neuralpde_tpu.utils.export`): a trained solution or
operator as a `torch.export` artifact.

`export_phi` and `export_pino_pde` trace the evaluation with the trained
parameters (and, for an operator, the grids) baked in as constants, and
return the serialized program with a ``call`` on it.  `save_exported` and
`load_exported` write and read it; a process that holds the file needs
only `torch` to run it:

    extra = {"matmul_precision": ""}
    program = torch.export.load(path, extra_files=extra).module()
    torch.backends.cuda.matmul.allow_tf32 = False      # for "highest"
    u = program(cord)

An `ExportedProgram` carries no matmul precision (the JAX package stamps
its dots with one), so the artifact records ``matmul_precision`` as
metadata, and ``call`` and `load_exported`'s call run under it: TF32 off
for ``"highest"`` (the default), on for ``"high"``/``"default"``, the
caller's setting for None.
"""

from __future__ import annotations

import contextlib
import io

import torch
from torch.export import Dim, export

from ..config import matmul_precision as _precision_of

PRECISION_KEY = "matmul_precision"
# the size the examples give a dynamic dimension: a prime that no layer
# width or grid size is likely to equal, so that tracing does not tie the
# dimension to another
_EXAMPLE = 1031


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _under(precision: str | None):
    """The body under ``precision`` (None: unchanged)."""
    if precision is None:
        return contextlib.nullcontext()
    return _precision_of(precision)


def _serialize(program, precision: str | None) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={
        PRECISION_KEY: "" if precision is None else precision})
    return buf.getvalue()


def _deserialize(source):
    """``source`` (bytes or a path) -> ``call(*inputs)`` under the recorded
    precision."""
    extra = {PRECISION_KEY: ""}
    program = torch.export.load(io.BytesIO(source) if isinstance(
        source, (bytes, bytearray)) else source, extra_files=extra)
    module = program.module()
    precision = extra[PRECISION_KEY] or None

    def call(*inputs):
        with _under(precision):
            return module(*inputs)

    call.matmul_precision = precision
    return call


def export_phi(phi, params: dict, in_dim: int, *, batch: int | None = None,
               dtype=torch.float32,
               matmul_precision: str | None = "highest"):
    """Export ``phi(cord, params)`` with ``params`` (cast to ``dtype``)
    baked in -> ``(artifact bytes, call(cord))``.

    ``batch=None`` gives a dynamic trailing dimension (any batch of
    ``(in_dim, N)`` points); otherwise the signature is ``(in_dim,
    batch)``.  The program lies on the parameters' device."""
    baked = {k: v.detach().to(dtype) for k, v in params.items()}
    device = next(iter(baked.values())).device
    example = torch.zeros((in_dim, _EXAMPLE if batch is None else batch),
                          dtype=dtype, device=device)
    # dynamic shapes go per element of forward's *args
    dynamic = None if batch is not None else (({1: Dim("n", min=1)},),)
    with torch.no_grad(), _under(matmul_precision):
        program = export(_Program(lambda cord: phi(cord, baked)), (example,),
                         dynamic_shapes=dynamic)
    blob = _serialize(program, matmul_precision)
    return blob, _deserialize(blob)


def export_pino_pde(sol, *, grids=None, n_family: int | None = None,
                    dtype=torch.float32):
    """Export a trained `PINOPDESolution` operator -> ``(artifact bytes,
    call(p, *input_values))``.

    The evaluation grids are baked in (``grids=None``: the training grids;
    an FNO transfers to any uniform grid over the same domains).  The
    signature is ``fn(p, *input_values)``: the parameter columns ``(n_ps,
    P)``, then one ``(*axis_sizes, P)`` array per input function in name
    order, in ``dtype``; they are cast to the solution's dtype inside.
    ``n_family=None`` makes P dynamic.  The recorded precision is the
    solve's (`PINOPDE(matmul_precision=)`), which the operator applies
    itself."""
    like = sol.p
    gs = (list(sol.grids) if grids is None
          else [torch.as_tensor(g, dtype=like.dtype,
                                device=like.device).reshape(-1)
                for g in grids])
    names = sorted(sol.input_samples)
    axes = sol.input_axes or {}

    def fn(p, *vals):
        return sol.interp(p.to(like.dtype), gs,
                          {k: v.to(like.dtype) for k, v in zip(names, vals)})

    n = _EXAMPLE if n_family is None else int(n_family)
    examples = [torch.zeros((like.shape[0], n), dtype=dtype,
                            device=like.device)]
    for name in names:
        sizes = tuple(int(gs[a].shape[0]) for a in axes[name])
        examples.append(torch.zeros((*sizes, n), dtype=dtype,
                                    device=like.device))
    dynamic = None
    if n_family is None:
        fam = Dim("n_family", min=1)
        dynamic = (tuple({e.ndim - 1: fam} for e in examples),)
    with torch.no_grad():
        program = export(_Program(fn), tuple(examples),
                         dynamic_shapes=dynamic)
    precision = getattr(sol, "matmul_precision", None)
    blob = _serialize(program, precision)
    return blob, _deserialize(blob)


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_exported(path: str):
    """Load a saved artifact -> ``call(*inputs)``, run under the precision
    the artifact records."""
    return _deserialize(path)

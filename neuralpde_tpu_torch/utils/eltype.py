"""Eltype adaptor (`neuralpde_tpu.utils.eltype`; reference:
src/eltype_matching.jl).

Converts the floating and complex tensor leaves of nested dicts, lists and
tuples to a target dtype, so that training data matches the parameters'
precision."""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves, tree_map


def _inexact(x: torch.Tensor) -> bool:
    return x.is_floating_point() or x.is_complex()


class EltypeAdaptor:
    """`EltypeAdaptor(torch.float32)(tree)` converts every floating or
    complex leaf; integer and boolean leaves stay as they are.  Leaves that
    are not tensors (numbers, numpy arrays) become tensors first."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __call__(self, tree):
        def conv(x):
            t = torch.as_tensor(x)
            return t.to(self.dtype) if _inexact(t) else t

        return tree_map(conv, tree)


def recursive_eltype(tree) -> torch.dtype:
    """The widest floating or complex dtype among the leaves (float32 when
    there is none), by torch's type promotion."""
    dtypes = [t.dtype for t in map(torch.as_tensor, tree_leaves(tree))
              if _inexact(t)]
    if not dtypes:
        return torch.float32
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out

"""Flat-vector <-> parameter-dict addressing.

Parameters are flat dicts of tensors keyed by dotted names
(``"depvar.layer_0.weight"``).  Leaves are ordered as
`jax.flatten_util.ravel_pytree` orders the JAX package's trees, so the two
flat vectors line up entry for entry: level by level, a dict's keys sorted
as strings (``"Ug" < "Uz" < "Wg" < "bg"``) and a list's entries by index
(``"nets.2"`` before ``"nets.10"``).
"""

from __future__ import annotations

import torch


def leaf_order(key: str) -> tuple:
    """Sort key of a dotted parameter name: one entry per level, an index
    (all digits) by its value and before any name."""
    return tuple((0, int(part), "") if part.isdigit() else (1, 0, part)
                 for part in key.split("."))


def parameters_to_vector(params: dict):
    """Flatten a parameter dict into a 1-D tensor; returns (vec, unravel)."""
    keys = sorted(params, key=leaf_order)
    shapes = [params[k].shape for k in keys]
    sizes = [params[k].numel() for k in keys]
    vec = torch.cat([params[k].reshape(-1) for k in keys]) if keys \
        else torch.zeros((0,))

    def unravel(v):
        parts = torch.split(v, sizes)
        return {k: p.reshape(s) for k, p, s in zip(keys, parts, shapes)}

    return vec, unravel


def vector_to_parameters(vec, like: dict) -> dict:
    """Reshape flat vector `vec` into the layout of parameter dict `like`."""
    _, unravel = parameters_to_vector(like)
    return unravel(vec)


def tree_size(params) -> int:
    """Number of entries over all tensor leaves of nested dicts and lists."""
    from torch.utils._pytree import tree_leaves

    return sum(torch.as_tensor(x).numel() for x in tree_leaves(params))

"""Flat-vector <-> parameter-dict addressing.

Parameters are flat dicts of tensors keyed by dotted names
(``"depvar.layer_0.weight"``).  Leaves are ordered by sorted key, which is
the order `jax.flatten_util.ravel_pytree` gives the JAX package's nested
dicts, so the two flat vectors line up entry for entry.
"""

from __future__ import annotations

import torch


def parameters_to_vector(params: dict):
    """Flatten a parameter dict into a 1-D tensor; returns (vec, unravel)."""
    keys = sorted(params)
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

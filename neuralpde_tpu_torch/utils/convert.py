"""Parameter exchange with the JAX package, through numpy arrays.

The JAX package keeps parameters as nested dicts
(``{"depvar": {"layer_0": {"weight": w, "bias": b}}}``); the port keeps one
flat dict keyed by the same path joined with dots
(``{"depvar.layer_0.weight": w, ...}``), which is also how `nn.Module`
names its parameters.  A list in the tree (the multilevel FBPINN's
``{"nets": [stack_0, stack_1]}``) contributes its index as one level of the
path (``"nets.0.layer_0.weight"``), as `nn.ModuleList` names its children.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, *, dtype=None, device=None) -> dict:
    """Nested dicts and lists of arrays -> flat dict of tensors with dotted
    keys (``{"depvar": ..., "p": ...}`` keeps ``"p"`` as it is).  A real
    ``dtype`` gives complex leaves the complex dtype of that width."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
            return
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
            return
        array = np.array(node)
        leaf_dtype = dtype
        if dtype is not None and np.iscomplexobj(array) and not dtype.is_complex:
            leaf_dtype = dtype.to_complex()
        out[prefix[:-1]] = torch.as_tensor(array, dtype=leaf_dtype,
                                           device=device)

    walk(tree, "")
    return out


def params_to_numpy(params: dict) -> dict:
    """Flat dict of tensors with dotted keys -> nested dict of numpy arrays
    (the inverse of `params_from_jax`): a level whose keys are the indices
    ``"0".."n-1"`` comes back as a list."""
    out: dict = {}
    for key, value in params.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(out)

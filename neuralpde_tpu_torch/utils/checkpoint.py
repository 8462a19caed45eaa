"""Checkpoint / resume (`neuralpde_tpu.utils.checkpoint`).

The JAX package's layout: ``params.npz`` (one array per parameter, under
its name), ``opt_state.npz`` (the optimizer's state) and ``meta.json``
(``iteration``, the parameters' names and shapes, the optimizer's
hyperparameters and the layout of its state).  The port adds
``generator.npz`` (the `torch.Generator`'s state, so a resumed run draws
the points of one that never stopped: the JAX package gets that from its
per-iteration key fold-in) and ``adaptive.npz`` (the adaptive-loss state).
A checkpoint whose names or shapes do not match the restore target raises
`ValueError`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pack(key: str, value, arrays: dict):
    """Store one optimizer-state value under ``key``; returns its layout:
    "tensor", "int", "float", "none", or ["list", [layouts...]] (L-BFGS
    keeps lists of tensors)."""
    if isinstance(value, torch.Tensor):
        arrays[key] = _to_numpy(value)
        return "tensor"
    if value is None:
        return "none"
    if isinstance(value, (list, tuple)):
        return ["list", [_pack(f"{key}.{j}", v, arrays)
                         for j, v in enumerate(value)]]
    arrays[key] = np.asarray(value)
    return "int" if isinstance(value, int) else "float"


def _unpack(key: str, layout, arrays):
    if layout == "tensor":
        return torch.from_numpy(arrays[key].copy())
    if layout == "none":
        return None
    if layout == "int":
        return int(arrays[key])
    if layout == "float":
        return float(arrays[key])
    return [_unpack(f"{key}.{j}", sub, arrays)
            for j, sub in enumerate(layout[1])]


def _flatten_optimizer(opt) -> tuple[dict, dict]:
    """``opt.state_dict()`` as arrays and a JSON description."""
    sd = opt.state_dict()
    arrays, layout = {}, {}
    for idx, entries in sd["state"].items():
        for name, value in entries.items():
            layout[f"{idx}.{name}"] = _pack(f"{idx}.{name}", value, arrays)
    return arrays, {"layout": layout, "param_groups": sd["param_groups"]}


def _unflatten_optimizer(arrays, meta) -> dict:
    state: dict = {}
    for key, layout in meta["layout"].items():
        idx, name = key.split(".", 1)
        state.setdefault(int(idx), {})[name] = _unpack(key, layout, arrays)
    return {"state": state, "param_groups": meta["param_groups"]}


def save_checkpoint(path: str, params: dict, optimizer=None,
                    iteration: int = 0, extra: dict | None = None, *,
                    generator: torch.Generator | None = None,
                    adaptive_state: dict | None = None) -> None:
    """Write a checkpoint: ``params`` (a dict of tensors), the optimizer's
    state, the iteration counter, and optionally the generator's state and
    the adaptive-loss state."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"),
             **{k: _to_numpy(v) for k, v in params.items()})
    meta = {"iteration": int(iteration),
            "params_shapes": {k: list(v.shape) for k, v in params.items()}}
    if optimizer is not None:
        arrays, meta["opt_state"] = _flatten_optimizer(optimizer)
        np.savez(os.path.join(path, "opt_state.npz"), **arrays)
    if generator is not None:
        np.savez(os.path.join(path, "generator.npz"),
                 state=_to_numpy(generator.get_state()))
    if adaptive_state is not None:
        np.savez(os.path.join(path, "adaptive.npz"),
                 **{k: _to_numpy(v) for k, v in adaptive_state.items()})
    if extra:
        meta.update(extra)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def has_checkpoint(path: str | None) -> bool:
    return (path is not None
            and os.path.exists(os.path.join(path, "params.npz"))
            and os.path.exists(os.path.join(path, "meta.json")))


def _check_like(what: str, data, like: dict) -> None:
    """Names and shapes of a saved dict of arrays against the target's."""
    if sorted(data.files) != sorted(like):
        raise ValueError(
            f"checkpoint {what} names do not match the restore target:\n"
            f"  saved: {sorted(data.files)}\n  want:  {sorted(like)}")
    for k, v in like.items():
        if tuple(data[k].shape) != tuple(v.shape):
            raise ValueError(
                f"checkpoint {what} {k!r} has shape {tuple(data[k].shape)}, "
                f"expected {tuple(v.shape)}")


def restore_checkpoint(path: str, params_like: dict, optimizer=None,
                       generator: torch.Generator | None = None,
                       adaptive_state: dict | None = None):
    """Restore in place into ``params_like`` (a dict of tensors, copied
    into), ``optimizer`` (its state loaded), ``generator`` and
    ``adaptive_state``, each where given and saved.  Names and shapes must
    match exactly.  Returns ``(params_like, optimizer, iteration)``."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, "params.npz"))
    _check_like("params", data, params_like)
    with torch.no_grad():
        for k, v in params_like.items():
            v.copy_(torch.from_numpy(data[k]))
    opt_path = os.path.join(path, "opt_state.npz")
    if optimizer is not None and os.path.exists(opt_path):
        sd = _unflatten_optimizer(np.load(opt_path), meta["opt_state"])
        optimizer.load_state_dict(sd)
    gen_path = os.path.join(path, "generator.npz")
    if generator is not None and os.path.exists(gen_path):
        generator.set_state(torch.from_numpy(np.load(gen_path)["state"]))
    ada_path = os.path.join(path, "adaptive.npz")
    if adaptive_state is not None and os.path.exists(ada_path):
        data = np.load(ada_path)
        _check_like("adaptive state", data, adaptive_state)
        for k, v in adaptive_state.items():
            v.copy_(torch.from_numpy(data[k]))
    return params_like, optimizer, meta.get("iteration", 0)

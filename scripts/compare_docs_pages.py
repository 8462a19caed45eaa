#!/usr/bin/env python3
"""Do the documentation pages that miss their JAX page's number differ
from the JAX package's pages on identical inputs?

A comparison tool in the manner of `tests/test_torch_*.py` (it imports the
JAX package and the PyTorch port and runs both on the CPU), for the ten
pages of ROADMAP §3 F1.  For each page:

1. The JAX page (``docs/src``) runs as `tests/test_docs_runner.py` runs it,
   at its own budget, with JAX's x64 on (the JAX runner's setting, so its
   problems are float64).  Every `solve` of the JAX package (the module
   function and every copy a module imported) records the parameters it
   starts from, and through its optimizer the parameters before every
   step (`jax.debug.callback`), and its result.
2. The port's page (``docs/torch``) runs through
   `scripts/torch_docs_runner.py` at its own budget on the CPU in float64
   (the runner's ``x64``: torch's default dtype, and the page's explicit
   float32 tensors written as float64).  Its `solve` calls are matched to
   the JAX page's in order: a call that starts from a fresh draw (not from an
   earlier solve's result) starts from the JAX call's parameters instead,
   where the two layouts name the same tensors; every call records as the
   JAX package's do.
3. One JSON line a page: both pages' last printed lines, and per solve
   the steps compared, the first step at which the parameters differ by
   more than 1e-8 relative (max |port - JAX| / max |JAX| over a tensor),
   and the difference at the end.

Draws the port makes itself (a stochastic strategy's points, a PINO
family, initial draws of parameters that no `solve` starts from) are not
passed across, so such a page differs from its first step: the line says
so through ``first_diverging_step`` 0.

    python scripts/compare_docs_pages.py [PAGE ...]   # default: the ten
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

PAGES = ["manual/pinns.md", "manual/pino_pde.md", "tutorials/ode.md",
         "tutorials/pdesystem.md", "tutorials/systems.md",
         "tutorials/derivative_neural_network.md",
         "tutorials/param_estim.md", "tutorials/low_level.md",
         "examples/nonlinear_elliptic.md", "examples/linear_parabolic.md"]
RTOL = 1e-8
_FENCE = re.compile(r"```python\n(.*?)```", re.DOTALL)


def _flat(tree) -> dict:
    """A JAX parameter tree -> flat numpy dict under the port's names."""
    from neuralpde_tpu_torch.utils.convert import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _rel(a: dict, b: dict) -> float:
    """Largest relative difference of two flat dicts over their tensors."""
    worst = 0.0
    for k, want in b.items():
        got = np.asarray(a[k], np.complex128 if np.iscomplexobj(want)
                         else np.float64)
        scale = max(float(np.max(np.abs(want))), 1e-300)
        worst = max(worst, float(np.max(np.abs(got - want))) / scale)
    return worst


def _patch_everywhere(package: str, original, replacement) -> list:
    """Point every module attribute of ``package`` bound to ``original`` at
    ``replacement``; returns the (module, name) pairs to undo."""
    done = []
    for name, mod in list(sys.modules.items()):
        if not (name == package or name.startswith(package + ".")):
            continue
        for attr, value in list(vars(mod).items()):
            if value is original:
                setattr(mod, attr, replacement)
                done.append((mod, attr))
    return done


@contextlib.contextmanager
def _jax_hooks(records: list):
    import jax
    import optax

    from neuralpde_tpu import train as jtrain

    original = jtrain.solve

    def recording(opt, sink):
        def init(params):
            return opt.init(params)

        def update(updates, state, params=None, **extra):
            jax.debug.callback(lambda p: sink.append(_to_numpy(p)), params,
                               ordered=True)
            return opt.update(updates, state, params, **extra)

        if isinstance(opt, optax.GradientTransformationExtraArgs):
            return optax.GradientTransformationExtraArgs(init, update)
        return optax.GradientTransformation(
            init, lambda u, s, p=None: update(u, s, p))

    def solve(prob, optimizer=None, *args, **kwargs):
        rec = {"start": _to_numpy(prob.init_params), "steps": []}
        records.append(rec)
        res = original(prob, recording(optimizer or optax.adam(1e-3),
                                       rec["steps"]), *args, **kwargs)
        jax.effects_barrier()
        rec["final"] = _to_numpy(res.u)
        return res

    undo = _patch_everywhere("neuralpde_tpu", original, solve)
    try:
        yield
    finally:
        for mod, attr in undo:
            setattr(mod, attr, original)


@contextlib.contextmanager
def _port_hooks(records: list, jax_records: list):
    import torch

    import neuralpde_tpu_torch as tpkg
    from neuralpde_tpu_torch import train as ttrain

    original = ttrain.solve
    results: dict = {}      # id -> tensor: kept alive, so no id is reused

    def recording(factory, keys, sink):
        def make(params):
            params = list(params)
            opt = factory(params)
            step = opt.step

            def recorded(*a, **k):
                sink.append({name: p.detach().cpu().numpy().copy()
                             for name, p in zip(keys, params)})
                return step(*a, **k)

            opt.step = recorded
            return opt

        return make

    def solve(prob, optimizer=None, *args, **kwargs):
        index = len(records)
        rec = {"steps": [], "substituted": False}
        records.append(rec)
        params = prob.init_params
        fresh = not any(id(v) in results for v in params.values())
        if fresh and index < len(jax_records):
            want = _flat(jax_records[index]["start"])
            if set(want) == set(params):
                params = {k: torch.as_tensor(want[k], dtype=v.dtype,
                                             device=v.device)
                          for k, v in params.items()}
                prob = _with_params(prob, params)
                rec["substituted"] = True
        rec["start"] = {k: v.detach().cpu().numpy() for k, v in
                        prob.init_params.items()}
        res = original(prob, recording(optimizer or tpkg.adam(1e-3),
                                       list(prob.init_params), rec["steps"]),
                       *args, **kwargs)
        rec["final"] = {k: v.detach().cpu().numpy() for k, v in res.u.items()}
        results.update((id(v), v) for v in res.u.values())
        return res

    undo = _patch_everywhere("neuralpde_tpu_torch", original, solve)
    try:
        yield
    finally:
        for mod, attr in undo:
            setattr(mod, attr, original)


def _with_params(prob, params):
    if hasattr(prob, "with_params"):
        return prob.with_params(params)
    prob.init_params = params
    return prob


def run_jax_page(page: str) -> tuple[list, list]:
    """The JAX page's blocks in one namespace, as `tests/test_docs_runner.py`
    runs them but at the page's own budget."""
    with open(os.path.join(ROOT, "docs", "src", page)) as f:
        sources = _FENCE.findall(f.read())
    records = []
    ns = {"__name__": f"docs_{os.path.basename(page)[:-3]}"}
    out = io.StringIO()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, _jax_hooks(records):
        os.chdir(tmp)
        try:
            for i, block in enumerate(sources):
                if block.lstrip().startswith("# docs-runner: skip"):
                    continue
                with contextlib.redirect_stdout(out):
                    exec(compile(block, f"docs/src/{page}#block{i}", "exec"),
                         ns)
        finally:
            os.chdir(cwd)
            ns.clear()
    return [ln for ln in out.getvalue().splitlines() if ln.strip()], records


def run_port_page(page: str, jax_records: list) -> tuple[list, list]:
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_docs_runner", os.path.join(ROOT, "scripts",
                                          "torch_docs_runner.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    records = []
    with _port_hooks(records, jax_records):
        res = runner.run_page(page, mode="full", device="cpu", x64=True)
    return res["printed"], records


def compare(jax_records: list, port_records: list) -> list[dict]:
    out = []
    for i, (j, t) in enumerate(zip(jax_records, port_records)):
        row = {"solve": i, "substituted": t["substituted"],
               "steps": [len(j["steps"]), len(t["steps"])],
               "first_diverging_step": None}
        jsteps = [_flat(p) for p in j["steps"]] + [_flat(j["final"])]
        tsteps = t["steps"] + [t["final"]]
        if set(jsteps[0]) != set(tsteps[0]):
            row["layouts_differ"] = [sorted(jsteps[0]), sorted(tsteps[0])]
            out.append(row)
            continue
        for k, (a, b) in enumerate(zip(tsteps, jsteps)):
            if _rel(a, b) > RTOL:
                row["first_diverging_step"] = k
                break
        row["rel_diff_at_end"] = _rel(tsteps[-1], jsteps[-1])
        out.append(row)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("pages", nargs="*", default=PAGES)
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    for page in args.pages:
        t0 = time.perf_counter()
        jax_printed, jax_records = run_jax_page(page)
        t1 = time.perf_counter()
        port_printed, port_records = run_port_page(page, jax_records)
        t2 = time.perf_counter()
        print(json.dumps({
            "page": page, "jax_seconds": round(t1 - t0, 1),
            "port_seconds": round(t2 - t1, 1),
            "solves": [len(jax_records), len(port_records)],
            "jax_printed": jax_printed[-12:],
            "port_printed": port_printed[-12:],
            "compared": compare(jax_records, port_records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run the Python blocks of the PyTorch port's documentation (`docs/torch/`).

The conventions are those of the JAX package's runner
(`tests/test_docs_runner.py`):

  * fenced ``python`` blocks run in file order, in one namespace per page;
  * any other fence language is prose;
  * a block whose first line is ``# docs-runner: skip`` never runs;
  * pages print their metrics rather than assert them; `CAPS` caps the
    budgets (the same keywords and values as the JAX runner's).

The port adds:

  * the first runnable block of a page binds ``DEVICE = "cuda"`` and the
    page passes ``device=DEVICE`` wherever an entry point takes a device.
    On another device the runner rewrites that one binding; on the card the
    page runs as it is written;
  * ``# docs-runner: cuda only <reason>`` as a block's first line runs the
    block on the card only, and ``# docs-runner: full only <reason>`` runs
    it only in the ``full`` mode (no caps).

Modes: ``capped`` (the caps, on any device: `tests/test_torch_docs_*.py`
on the CPU, `chip_smoke.py` phase 35 on the card) and ``full`` (no caps,
the pages' own budgets).  `CPU_CAPS` caps a few more keywords on the CPU
only, where a page at `CAPS` takes more than a few seconds.

Variants of a page (its accuracy against the JAX page's, ROADMAP §3 F1):
``--x64`` runs it in float64 (torch's default dtype, and the page's own
``torch.float32`` written as ``torch.float64``); ``--seed S`` passes
``seed=S`` to every `SEEDED` entry point of the port's top level that the
page calls without one, so its initial parameters (and a stochastic
strategy's points) come from another draw.

Each page runs in a fresh temporary directory (pages that write
checkpoints or exports write there), and what a page changes of the
process's global state is put back after it: torch's default dtype, the
TF32 flags, the active mesh, a process group the page made, anomaly
detection, the global random states and the current directory.

Run on the card, one page or all of them, printing one JSON line a page
(seconds, the page's printed lines, its ``tanh_jet2`` launches counted with
the replays of captured graphs):

    python scripts/torch_docs_runner.py [--mode capped|full]
        [--device cuda|cpu] [--x64] [--seed S] [--out FILE] [PAGE ...]

PAGE is a path relative to ``docs/torch`` (``tutorials/ode.md``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import io
import json
import os
import random
import re
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs", "torch")
if ROOT not in sys.path:    # the port, when this file runs as a script
    sys.path.insert(0, ROOT)

_FENCE = re.compile(r"```python\n(.*?)```", re.DOTALL)
_DEVICE = re.compile(r'^DEVICE = "cuda"$', re.MULTILINE)
_NONFINITE = re.compile(r"\b(?:nan|inf)\b", re.IGNORECASE)

# caps applied to keyword arguments in the pages' code, those of
# tests/test_docs_runner.py
CAPS = {
    "maxiters": 120,
    "draw_samples": 40,
    "numensemble": 10,
    "nchains": 2,
    "adam_iters": 60,
    "lbfgs_iters": 60,
}
# further caps on the CPU only, where a page at `CAPS` takes more than a
# few seconds: the optimizer steps of every solve, Gauss-Newton's inner CG
# iterations and the leapfrog steps of a Bayesian draw
CPU_CAPS = {
    "maxiters": 20,
    "cg_iters": 5,
    "n_leapfrog": 5,
}


# the port's entry points whose ``seed`` draws a page's initial parameters
# or points (`--seed`)
SEEDED = ("PhysicsInformedNN", "NNODE", "PINOPDE", "solve", "solve_ode")


def pages() -> list[str]:
    """Every page under ``docs/torch``, relative to it, sorted."""
    out = []
    for root, _, files in os.walk(DOCS):
        for f in files:
            if f.endswith(".md"):
                out.append(os.path.relpath(os.path.join(root, f), DOCS))
    return sorted(out)


def blocks(page: str) -> list[str]:
    """The ``python`` blocks of ``page`` (relative to ``docs/torch``)."""
    with open(os.path.join(DOCS, page)) as f:
        return _FENCE.findall(f.read())


def _directive(code: str) -> str:
    first = code.lstrip().split("\n", 1)[0].strip()
    if first.startswith("# docs-runner:"):
        return first[len("# docs-runner:"):].strip()
    return ""


def runs(code: str, mode: str, device: str) -> bool:
    """Whether a block runs in ``mode`` on ``device``."""
    d = _directive(code)
    if d.startswith("skip"):
        return False
    if d.startswith("cuda only"):
        return torch.device(device).type == "cuda"
    if d.startswith("full only"):
        return mode == "full"
    return True


def downscale(code: str, caps: dict) -> str:
    """Cap every ``keyword=<int>`` of ``caps`` in ``code``."""
    def cap(m):
        kw, val = m.group(1), int(m.group(2))
        return f"{kw}={min(val, caps[kw])}"

    pat = re.compile(r"\b(" + "|".join(caps) + r")\s*=\s*(\d+)\b")
    return pat.sub(cap, code)


def prepare(code: str, mode: str, device: str, x64: bool = False) -> str:
    """The block as it runs: the caps of ``mode`` applied, the ``DEVICE``
    binding rewritten for ``device``, and with ``x64`` its float32 dtypes
    written as float64."""
    if mode == "capped":
        code = downscale(code, CAPS)
        if torch.device(device).type == "cpu":
            code = downscale(code, CPU_CAPS)
    elif mode != "full":
        raise ValueError(f"unknown mode {mode!r}")
    if device != "cuda":
        code = _DEVICE.sub(f"DEVICE = {device!r}", code)
    if x64:
        code = code.replace("torch.float32", "torch.float64")
    return code


@contextlib.contextmanager
def seeded(seed: int | None):
    """The port's `SEEDED` entry points with ``seed=seed`` wherever a call
    passes none (nothing for None)."""
    import neuralpde_tpu_torch as npde

    saved = {name: getattr(npde, name) for name in SEEDED}

    def with_seed(f):
        @functools.wraps(f)
        def call(*args, **kwargs):
            kwargs.setdefault("seed", seed)
            return f(*args, **kwargs)
        return call

    if seed is not None:
        for name, f in saved.items():
            setattr(npde, name, with_seed(f))
    try:
        yield
    finally:
        for name, f in saved.items():
            setattr(npde, name, f)


@contextlib.contextmanager
def restored_state():
    """Put back what a page may change of the process's global state."""
    from neuralpde_tpu_torch.parallel import mesh as mesh_mod

    dist = torch.distributed.is_available()
    had_group = dist and torch.distributed.is_initialized()
    saved = dict(
        dtype=torch.get_default_dtype(),
        tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        mesh=mesh_mod._ACTIVE_MESH,
        anomaly=torch.is_anomaly_enabled(),
        cwd=os.getcwd(),
        torch_rng=torch.random.get_rng_state(),
        np_rng=np.random.get_state(),
        py_rng=random.getstate(),
        path=list(sys.path),
    )
    try:
        yield
    finally:
        os.chdir(saved["cwd"])
        sys.path[:] = saved["path"]
        torch.set_default_dtype(saved["dtype"])
        torch.backends.cuda.matmul.allow_tf32 = saved["tf32"]
        torch.backends.cudnn.allow_tf32 = saved["cudnn_tf32"]
        mesh_mod._ACTIVE_MESH = saved["mesh"]
        torch.autograd.set_detect_anomaly(saved["anomaly"])
        torch.random.set_rng_state(saved["torch_rng"])
        np.random.set_state(saved["np_rng"])
        random.setstate(saved["py_rng"])
        if dist and not had_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class PageError(RuntimeError):
    """A block of a page raised."""


class _Tee(io.TextIOBase):
    """Write to a stream and keep a copy."""

    def __init__(self, stream):
        self.stream, self.kept = stream, io.StringIO()

    def write(self, s):
        self.kept.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def run_page(page: str, *, mode: str = "capped", device: str = "cuda",
             echo: bool = False, x64: bool = False,
             seed: int | None = None) -> dict:
    """Run every block of ``page`` that runs in ``mode`` on ``device``
    (in float64 with ``x64``; ``seed``: `seeded`).

    Returns ``{"page", "mode", "device", "blocks", "skipped", "seconds",
    "block_seconds", "printed": [lines], "eager_launches",
    "replayed_launches", "launches": {kernel: n}}``:
    the ``tanh_jet2`` launches through the wrappers (eager steps and
    captures; the counts are reset first), those made by replays of
    captured graphs, and their sum.  Raises `PageError` when a block
    raises."""
    from neuralpde_tpu_torch.kernels import tanh_jet as tj

    sources = blocks(page)
    ns = {"__name__": f"docs_{os.path.basename(page)[:-3]}"}
    out = _Tee(sys.stdout if echo else io.StringIO())
    ran = skipped = 0
    block_seconds = []
    tj.reset_launch_counts()
    replayed_before = tj.replayed_counts()
    t0 = time.perf_counter()
    with restored_state(), seeded(seed), tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        if x64:
            torch.set_default_dtype(torch.float64)
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)   # a page's imports of the port
        try:
            for i, block in enumerate(sources):
                if not runs(block, mode, device):
                    skipped += 1
                    continue
                code = prepare(block, mode, device, x64)
                tb = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(out):
                        exec(compile(code, f"docs/torch/{page}#block{i}",
                                     "exec"), ns)
                except Exception as e:
                    raise PageError(f"{page} block {i} failed: "
                                    f"{type(e).__name__}: {e}\n--- code "
                                    f"---\n{code}") from e
                ran += 1
                block_seconds.append(round(time.perf_counter() - tb, 3))
        finally:
            # the page's functions hold its namespace as their globals: a
            # cycle that would keep its tensors (and graphs) alive
            ns.clear()
            gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    printed = [ln for ln in out.kept.getvalue().splitlines() if ln.strip()]
    eager = tj.launch_counts()
    replayed = {k: n - replayed_before[k]
                for k, n in tj.replayed_counts().items()}
    return {"page": page, "mode": mode, "device": str(device),
            "x64": x64, "seed": seed, "blocks": ran, "skipped": skipped, "seconds": seconds,
            "block_seconds": block_seconds,
            "printed": printed,
            "eager_launches": eager, "replayed_launches": replayed,
            "launches": {k: eager[k] + replayed[k] for k in eager}}


def nonfinite(result: dict) -> list[str]:
    """The printed lines of a page's result that hold a NaN or an inf."""
    return [ln for ln in result["printed"] if _NONFINITE.search(ln)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pages", nargs="*", help="pages relative to docs/torch "
                    "(default: every page)")
    ap.add_argument("--mode", default="capped", choices=["capped", "full"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--x64", action="store_true",
                    help="run the pages in float64")
    ap.add_argument("--seed", type=int, default=None,
                    help="the seed of the entry points a page seeds by "
                         "default (SEEDED)")
    ap.add_argument("--out", default=None,
                    help="append each page's JSON line to this file too")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("no CUDA device", file=sys.stderr)
        return 1
    failed = 0
    for page in args.pages or pages():
        try:
            res = run_page(page, mode=args.mode, device=args.device,
                           echo=True, x64=args.x64, seed=args.seed)
        except PageError as e:
            print(str(e), file=sys.stderr)
            res = {"page": page, "mode": args.mode, "error": str(e)[:2000]}
            failed += 1
        else:
            if nonfinite(res):
                res["error"] = f"non-finite metric: {nonfinite(res)}"
                failed += 1
        if torch.cuda.is_available():
            res["card"] = torch.cuda.get_device_name(0)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

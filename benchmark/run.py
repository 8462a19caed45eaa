"""Benchmark of neuralpde_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout.  ``NAME`` is a cell of ``BENCHMARK.json``;
its configuration (``configs/<config>.json``) and its workload file
(``workloads/<NAME>.json``: the traffic driver, its parameters and the
limits of the comparison) are found by name, and the driver
``traffic/<driver>.py`` runs it.  Every per-layer metric is read by
``metrics/<metric>.py``.  Set-up (from the start of this process to the
first timed step) builds the problem through the program's public API,
makes its parameters and points from ``--seed``, and warms up the cell's
own shapes; the window then runs for ``--seconds``; a traced run then
traces one block of a fresh ``solve`` (one trial in the to-target cell).  Once the window has closed and the program's
state is freed, the plain reference (``reference/``) follows the
program's first steps and decides ``correct``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which are also the last lines of standard error.  Without enough CUDA
cards, or with JAX or the JAX package loaded once the window has closed,
it exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()      # set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import runpy  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

# modules whose top-level name may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "neuralpde_tpu")
# kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of `FORBIDDEN`."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads``, with its files."""

    def __init__(self, name: str, root: str = ROOT):
        spec = read_json(os.path.join(root, "BENCHMARK.json"))
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = read_json(os.path.join(
            root, configs[self.entry["config"]]["file"]))
        self.workload = read_json(os.path.join(HERE, "workloads",
                                               f"{name}.json"))
        if self.workload["traffic"] != self.entry["traffic"]:
            raise SystemExit(f"{name}: BENCHMARK.json names the traffic "
                             f"{self.entry['traffic']!r}, its workload file "
                             f"{self.workload['traffic']!r}")
        self.chips = self.entry["chips"]

        def here(m):
            return name in m["workloads"] if "workloads" in m else None

        self.end_to_end = [m["name"] for m in spec["end_to_end"]
                           if here(m) is not False]
        self.per_layer = [m["name"] for m in spec["per_layer"]
                          if here(m) or (here(m) is None
                                         and m["moves"] in self.end_to_end)]


class Context:
    """What a traffic driver is given."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, npde, t_start: float, overrides=None, preload=None):
        overrides = overrides or {}
        self.cell, self.overrides, self.preload = cell, overrides, preload
        self.config = {**cell.config, **overrides.get("config", {})}
        self.workload = {**cell.workload, **overrides.get("workload", {})}
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.npde, self.t_start = device, npde, t_start

    def mark(self, what: str) -> None:
        """Log ``what`` with the seconds since the process started."""
        print(f"[benchmark] {time.perf_counter() - self.t_start:9.3f} s "
              f"{what}", file=sys.stderr, flush=True)

    def launch_shapes(self) -> dict:
        """The program's record of the ``tanh_jet2`` shapes it launched:
        ``{kernel: [shape, ...]}``."""
        from neuralpde_tpu_torch.kernels import tanh_jet

        out = {}
        for kernel, shape in tanh_jet.LAUNCH_SHAPES:
            out.setdefault(kernel, []).append(shape)
        return out


def import_program():
    """The port, from this checkout and nowhere else."""
    import neuralpde_tpu_torch as npde

    where = os.path.dirname(os.path.abspath(npde.__file__))
    if os.path.dirname(where) != ROOT:
        raise SystemExit(f"neuralpde_tpu_torch was imported from {where}, "
                         f"not from this checkout ({ROOT})")
    return npde


def load_driver(ctx: Context):
    """The cell's traffic driver, ``traffic/<driver>.py``."""
    name = ctx.workload["driver"]
    return load_file(os.path.join(HERE, "traffic", f"{name}.py"),
                     f"traffic_{name}")


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def layer_metrics(cell: Cell, layer: dict) -> dict:
    """The cell's per-layer metrics, each read by ``metrics/<name>.py``;
    a reader that finds nothing leaves its metric out."""
    spec = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    units = {m["name"]: m["unit"] for m in spec["per_layer"]}
    out = {}
    for name in cell.per_layer:
        reader = load_file(os.path.join(HERE, "metrics", f"{name}.py"),
                           f"metric_{name.replace('.', '_')}")
        value = reader.read(layer)
        if value is not None:
            out[name] = {"value": value, "unit": units[name]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides=None, t_start: float = T_START,
             preload=None) -> dict:
    """Run one cell and return its result line (a dict).  ``device="cpu"``,
    ``overrides`` (``{"config": {...}, "workload": {...}}`` laid over the
    files) and ``preload`` (a Python file that every rank process runs
    first) serve the tests: a run on the CPU reports no metric."""
    from reference import compare

    cell = Cell(name)
    npde = import_program()
    if preload:
        runpy.run_path(preload)
    ctx = Context(cell, seed, seconds, trace, device, npde, t_start,
                  overrides, preload)
    out = load_driver(ctx).run(ctx)
    values = compare.readings(out["program"], out["reference"])
    correct, checks = compare.judge(values, ctx.workload["limits"])
    on_card = out["device"]["platform"] == "gpu"
    if not on_card:
        metrics = {}
    elif trace:
        metrics = layer_metrics(cell, out["layer"])
    else:
        units = {m["name"]: m["unit"] for m in read_json(
            os.path.join(ROOT, "BENCHMARK.json"))["end_to_end"]}
        metrics = {k: {"value": out["e2e"][k], "unit": units[k]}
                   for k in cell.end_to_end if k in out["e2e"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(out["device"])}
    bd = out["layer"].get("breakdown")
    if on_card and trace and bd is not None:
        line["device"]["busy_s"] = out["layer"].get("busy_s", bd["busy_s"])
        line["device"]["window_s"] = out["layer"].get("window_s",
                                                      bd["window_s"])
        line["breakdown"] = {"device_ops": bd["device_ops"],
                             "idle_gaps": bd["idle_gaps"]}
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def emit(line: dict) -> int:
    """Print the checks on standard error and the line on standard output,
    unless a forbidden module is loaded: then print what was found and
    return 4."""
    found = forbidden_modules()
    if found:
        print(f"[benchmark] forbidden modules loaded: {found}",
              file=sys.stderr, flush=True)
        return 4
    for k, c in line["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


def rank_of(blob: str) -> int:
    """A rank other than 0 of a multi-card cell (started by its driver)."""
    args = json.loads(blob)
    cell = Cell(args["workload"])
    npde = import_program()
    if args["preload"]:
        runpy.run_path(args["preload"])
    ctx = Context(cell, args["seed"], args["seconds"], args["trace"],
                  args["device"], npde, time.perf_counter(),
                  args["overrides"], args["preload"])
    load_driver(ctx).rank_main(ctx, args["rank"], args["world"],
                               args["port"])
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-of"]:
        return rank_of(argv[1])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "cache", sub)
    cell = Cell(args.workload)
    import torch

    from harness import log, power_line

    if not torch.cuda.is_available():
        log("no CUDA card (torch.cuda.is_available() is False)")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"torch.cuda.device_count() is {torch.cuda.device_count()}")
        return 3
    log(f"cards: {power_line()}")
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    return emit(line)


if __name__ == "__main__":
    sys.exit(main())

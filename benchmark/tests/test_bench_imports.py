"""Nothing a benchmark run imports is JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import _bench_setup as setup

FORBIDDEN = ("jax", "jaxlib", "flax", "neuralpde_tpu")


def _imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(setup.BENCH, "**", "*.py"),
                      recursive=True)
    found = {(os.path.relpath(f, setup.BENCH), top) for f in files
             for top in _imported_tops(f) if top in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(setup.BENCH, "reference", "*.py"))
    assert files
    for f in files:
        assert "neuralpde_tpu_torch" not in set(_imported_tops(f)), f


def test_top_level_names_are_compared_whole():
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["neuralpde_tpu_torch_like"] = sys
        sys.modules["jaxish"] = sys
        assert run.forbidden_modules() == []
        sys.modules["neuralpde_tpu.train"] = sys
        assert run.forbidden_modules() == ["neuralpde_tpu.train"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_forbidden_module():
    """Everything `run.py` loads for every cell (drivers, readers, the
    program) in a fresh process."""
    code = (
        "import sys, os, glob; sys.path[:0] = [%r, %r]\n"
        "import run, readings\n"
        "run.import_program()\n"
        "for name in run.read_json(os.path.join(run.ROOT, 'BENCHMARK.json'))"
        "['workloads']:\n"
        "    cell = run.Cell(name['name'])\n"
        "    run.load_file(os.path.join(run.HERE, 'traffic', "
        "cell.workload['driver'] + '.py'), 'd')\n"
        "    for m in cell.per_layer:\n"
        "        run.load_file(os.path.join(run.HERE, 'metrics', m + '.py'),"
        " 'm')\n"
        "print(run.forbidden_modules())\n" % (setup.ROOT, setup.BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=setup.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

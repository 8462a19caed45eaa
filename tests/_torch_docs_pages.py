"""The page cases of the port's documentation (`docs/torch/`), shared by
the four files that run them, one a docs section
(`tests/test_torch_docs_{developer,examples,manual,tutorials}.py`), so that
under ``--dist loadfile`` the sections run on separate workers.

A page's ``python`` blocks execute on the CPU through the shared runner
(`scripts/torch_docs_runner.py`, the runner `chip_smoke.py` phase 35 uses
on the card) under its ``capped`` budgets, with the ``DEVICE`` binding
rewritten to ``"cpu"``; a page with no python block is skipped as
`tests/test_docs_runner.py` skips one, and no printed metric may be a NaN
or an inf.  The coverage tests stay in `tests/test_torch_docs_runner.py`.
"""

import importlib.util
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")

_spec = importlib.util.spec_from_file_location(
    "torch_docs_runner", os.path.join(ROOT, "scripts", "torch_docs_runner.py"))
runner = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(runner)

# each file's pages: those under these directories or at these paths
SECTIONS = {"developer": ("developer/", "index.md"),
            "examples": ("examples/",),
            "manual": ("manual/",),
            "tutorials": ("tutorials/",)}


def section(name: str) -> list[str]:
    """The pages of section ``name``, sorted."""
    return [p for p in runner.pages() if p.startswith(SECTIONS[name])]


def run_page_case(page: str) -> None:
    if not runner.blocks(page):
        pytest.skip("no python blocks")
    try:
        res = runner.run_page(page, mode="capped", device="cpu")
    except runner.PageError as e:
        pytest.fail(str(e))
    assert res["blocks"] > 0
    assert not runner.nonfinite(res), runner.nonfinite(res)

"""The port's documentation (`docs/torch/`): coverage.

Every page's ``python`` blocks run on the CPU in the four section files
(`tests/test_torch_docs_{developer,examples,manual,tutorials}.py`, through
`tests/_torch_docs_pages.py`), which together take every page once.  Here:
one port page per `docs/src` page at the same relative path and no other;
each page has substance (>= 60 lines, the JAX pages' rule); no block
imports JAX, optax, flax, haiku or the JAX package, and every
`neuralpde_tpu_torch` name a block imports resolves; the first runnable
block of a page binds ``DEVICE = "cuda"``; no line that names the TPU, the
v5e or XLA states a number unless it quotes the JAX package and says so.
"""

import ast
import importlib
import importlib.util
import os
import re

from _torch_docs_pages import ROOT, SECTIONS, runner, section

JAX_DOCS = os.path.join(ROOT, "docs", "src")

FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "haiku", "neuralpde_tpu"}
_TPU = re.compile(r"\b(TPU|v5e|XLA)\b")


def _jax_pages():
    out = []
    for root, _, files in os.walk(JAX_DOCS):
        out += [os.path.relpath(os.path.join(root, f), JAX_DOCS)
                for f in files if f.endswith(".md")]
    return sorted(out)


def _text(page):
    with open(os.path.join(runner.DOCS, page)) as f:
        return f.read()


def test_every_jax_page_has_its_port_and_no_other():
    assert runner.pages() == _jax_pages()


def test_the_section_files_run_every_page_once():
    runs = sorted(p for name in SECTIONS for p in section(name))
    assert runs == runner.pages()


def test_port_pages_have_substance():
    thin = [(p, len(_text(p).splitlines())) for p in runner.pages()
            if len(_text(p).splitlines()) < 60]
    assert not thin, f"stub pages: {thin}"


def test_port_pages_import_only_the_port_and_their_names_resolve():
    bad, missing = [], []
    for page in runner.pages():
        for i, block in enumerate(runner.blocks(page)):
            for node in ast.walk(ast.parse(block)):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                else:
                    continue
                for m in mods:
                    if m.split(".")[0] in FORBIDDEN:
                        bad.append(f"{page}#{i}: {m}")
                if (isinstance(node, ast.ImportFrom) and node.module
                        .split(".")[0] == "neuralpde_tpu_torch"):
                    mod = importlib.import_module(node.module)
                    missing += [
                        f"{page}#{i}: {node.module}.{a.name}"
                        for a in node.names if not hasattr(mod, a.name)
                        and not importlib.util.find_spec(
                            f"{node.module}.{a.name}")]
    assert not bad, f"blocks importing JAX or the JAX package: {bad}"
    assert not missing, f"unresolved imports: {missing}"


def test_first_runnable_block_binds_the_card():
    wrong = []
    for page in runner.pages():
        runnable = [b for b in runner.blocks(page)
                    if runner.runs(b, "full", "cuda")]
        if runnable and not re.search(r'^DEVICE = "cuda"$', runnable[0],
                                      re.MULTILINE):
            wrong.append(page)
    assert not wrong, f'first runnable block without DEVICE = "cuda": {wrong}'


def test_no_tpu_numbers_except_quoted_jax_records():
    found = []
    for page in runner.pages():
        for n, line in enumerate(_text(page).splitlines(), 1):
            if (_TPU.search(line) and re.search(r"\d", line)
                    and "JAX package" not in line):
                found.append(f"{page}:{n}: {line.strip()}")
    assert not found, "numbers beside TPU/v5e/XLA:\n" + "\n".join(found)

"""The port's documentation runs on the port: the examples pages of
`docs/torch/`, each under the runner's capped budgets on the CPU
(`tests/_torch_docs_pages.py` says how)."""

import pytest

from _torch_docs_pages import run_page_case, section


@pytest.mark.parametrize("page", section("examples"))
def test_docs_page_runs_on_the_port(page):
    run_page_case(page)

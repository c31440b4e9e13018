"""The ``root`` fixture: a checkout of the benchmark at test size."""

import pytest

from perfbench_testroot import make_root


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path / "checkout")

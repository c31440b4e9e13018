"""The repo's lock checker (``tools/analysis``: C001 guarded access, C002
lock-order cycles, C003 unguarded stores in thread-spawning classes) over
the port's package, ``rabit_tpu_torch``, which its default roots leave
out: no C001 or C002 finding, every C003 site guarded or justified with
``# noqa: C003`` and a reason, and every guard spelt as the checker reads
it (``# guarded-by: <lock>``)."""

import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "rabit_tpu_torch"


def _analysis():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import analysis
    finally:
        sys.path.pop(0)
    return analysis


@pytest.fixture(scope="module")
def findings():
    a = _analysis()
    found, n_files = a.run_paths([str(PORT)],
                                 codes={"C001", "C002", "C003"})
    assert n_files > 50
    return found


@pytest.mark.parametrize("code", ["C001", "C002", "C003"])
def test_no_lock_finding_over_the_port(findings, code):
    assert [f for f in findings if f[2] == code] == []


def test_guards_are_spelt_as_the_checker_reads_them():
    """A guard comment the checker cannot read protects nothing: every
    ``guarded by`` in the port's source is ``# guarded-by: <lock>``."""
    bad = []
    for path in PORT.rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"#\s*guarded[ _]by\b", line):
                bad.append(f"{path.relative_to(ROOT)}:{i}")
    assert bad == []


def test_every_c003_justification_gives_a_reason():
    """``# noqa: C003`` is followed by `` - <why>`` or sits under a
    comment that says why."""
    bare = []
    for path in PORT.rglob("*.py"):
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "# noqa: C003" not in line:
                continue
            reason = re.search(r"# noqa: C003\s+-\s+\S", line)
            above = i > 0 and "C003" in lines[i - 1] and \
                lines[i - 1].lstrip().startswith("#")
            if not (reason or above):
                bare.append(f"{path.relative_to(ROOT)}:{i + 1}")
    assert bare == []

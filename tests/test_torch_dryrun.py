"""``entry.dryrun_multichip`` and ``tools.long_context``, the port's runs
of every parallelism family, in spawned gloo worlds on the CPU: the
dryrun at world 4 (the transformer over (2, 2, 1), the MLP over (2, 2),
the pipeline over pp 4, the MoE over ep 4, the bf16 and int8 ring
allreduce) prints JAX's lines and raises on a failing family; the axis
split is ``__graft_entry__._axis_factors``; the long-context tool's
ring attention agrees with the dense oracle and its loss falls."""

import pytest

from rabit_tpu_torch import entry
from rabit_tpu_torch.tools import long_context


@pytest.mark.parametrize("n", range(1, 9))
def test_axis_factors_are_the_jax_entry_points(n):
    import __graft_entry__
    assert entry._axis_factors(n) == __graft_entry__._axis_factors(n)


def test_dryrun_multichip_at_world_four_on_gloo(capsys):
    entry.dryrun_multichip(4, "cpu")
    lines = capsys.readouterr().out.splitlines()
    for head in ("dryrun transformer ok: mesh=(2x2x1) loss",
                 "dryrun mlp ok: mesh=(2x2) loss", "dryrun pipeline ok: pp=4",
                 "dryrun moe ok: ep=4",
                 "dryrun quantized wire ok: bf16+int8 over 4 devices"):
        assert any(line.startswith(head) for line in lines), (head, lines)


def test_a_non_finite_loss_fails_its_family():
    """A family that goes non-finite fails the run (in the rank, which the
    launcher turns into an error of the whole world)."""
    with pytest.raises(RuntimeError, match="non-finite"):
        entry._finite(1.0, float("nan"))


def test_long_context_tool_on_gloo(capsys):
    got = long_context.run(2, entry.resolve_device("cpu"))
    assert got["err"] < long_context.ORACLE_TOL
    assert got["seq"] == 2 * long_context.T_RANK
    assert got["losses"][-1] < got["losses"][0]
    out = capsys.readouterr().out
    assert "ring attention: seq=1024 over 2 ranks" in out


def test_without_cuda_both_entry_points_raise(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    with pytest.raises(SystemExit):
        long_context.main(["--world", "2"])

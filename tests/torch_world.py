"""Spawn a world of the port for a test: ``p`` processes meet in a
``FileStore`` under ``tmp_path`` (gloo on the CPU, or NCCL with rank r on
card r), each runs ``fn(rank, p, *args)`` and saves the dict of arrays it
returns; the parent returns them in rank order. The port's own launcher,
``rabit_tpu_torch.tools.run_world``, does the work. Imports neither JAX
nor ``rabit_tpu``."""

from rabit_tpu_torch.tools import run_world

SPAWN_TIMEOUT_S = 240


def _call(rank: int, p: int, device, fn, args: tuple) -> dict:
    return fn(rank, p, *args)


def spawn_world(fn, p: int, tmp_path, *args, backend: str = "gloo") -> list:
    """Run ``fn(rank, p, *args) -> dict of arrays`` in a world of ``p``
    and return each rank's dict."""
    return run_world(_call, p, "cuda" if backend == "nccl" else "cpu",
                     args=(fn, args), timeout_s=SPAWN_TIMEOUT_S,
                     arrays=True, tmp=str(tmp_path))

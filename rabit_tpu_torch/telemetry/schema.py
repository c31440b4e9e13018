"""Schema-versioned artifact headers: the port's own copy of
``rabit_tpu/telemetry/schema.py``. The ``schema`` ids keep the JAX
package's ``rabit_tpu.`` prefix, so one consumer routes either package's
telemetry summaries, traces and fleet documents (and the dispatch
tables' ``rabit_tpu.collective_sweep/v*``) by that field and rejects
foreign majors without guessing at ad-hoc fields.

Stdlib-only: the tracker imports it without torch.
"""

from __future__ import annotations

import datetime

SCHEMA_PREFIX = "rabit_tpu."


def schema_id(kind: str, version: int = 1) -> str:
    """``rabit_tpu.<kind>/v<version>`` — the exact-match schema string
    (same shape as ``parallel/dispatch.py``'s collective_sweep/v1)."""
    return f"{SCHEMA_PREFIX}{kind}/v{version}"


def timestamp_utc() -> str:
    """The repo's artifact timestamp format (``20260731T011414Z`` —
    lexicographic order == capture order, which the dispatch-table and
    capture-status discovery rely on)."""
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y%m%dT%H%M%SZ")


def make_header(kind: str, version: int = 1) -> dict:
    """Header fields every emitted artifact starts from."""
    return {"schema": schema_id(kind, version),
            "timestamp_utc": timestamp_utc()}


def matches(data, kind: str, version: int = 1) -> bool:
    """Exact schema match — future majors must not be misread as ours
    (the dispatch-table loader's rule, applied uniformly)."""
    return isinstance(data, dict) and data.get("schema") == schema_id(
        kind, version)

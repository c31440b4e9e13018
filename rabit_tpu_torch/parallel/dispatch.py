"""Measured dispatch for ``collectives.allreduce(method="auto")``: the
port of ``rabit_tpu/parallel/dispatch.py``.

The reference picks its allreduce algorithm from one hard-coded constant
(``reduce_ring_mincount = 32768``, allreduce_base.cc:35).
``python -m rabit_tpu_torch.tools.collective_sweep`` replaces the
constant with data: it times {tree, ring, bidir, swing, hier} x {wire
none/bf16/int8/int8:bf16} x payload sizes over NCCL (one process a card)
and writes a schema-versioned ``COLLECTIVE_SWEEP_*.json`` whose
``table`` section this module loads. With no table (or an unreadable or
foreign-schema file) dispatch falls back to the constants below.

Tables are read from ``RABIT_DISPATCH_TABLE``, then the port's own
``build/artifacts/``, then, in an NCCL world only, the table committed
under ``parallel/tables/`` (a sweep at world 4 on H100s over NVLink: a
fresh checkout has no ``build/``), never from ``benchmarks/artifacts/``:
the tables there were measured by the JAX package on a TPU and on a
virtual CPU mesh, not on the card. The committed table was measured over
NCCL, so a gloo world on the CPU keeps the fallback constants.

Wire quantization is LOSSY, so it is never auto-enabled: the table (or,
without a table, the ``rabit_dataplane_wire_mincount`` size gate) only
decides *when* a wire the user explicitly requested (per-call ``wire=``
beats the gate; ``rabit_dataplane_wire`` config/env is gated) actually
engages.

With telemetry on (``rabit_tpu_torch.telemetry``) every :func:`resolve`
counts its outcome (``dispatch`` rows with the provenance ``explicit``,
``table`` or ``fallback``, and ``wire.quantized`` rows with the wire's),
and the table loader counts its cache hits and misses in the profiling
plane (``dispatch_table``), as the JAX package does.

With ``rabit_skew_adapt`` on and the fleet-agreed skew digest
(``telemetry/skew.py``) naming a laggard of this world, ``"auto"``
prefers the skew-tolerant schedules and records the provenance
``skew_adapted`` and a ``dispatch.skew_adapted`` count; the concrete
plan is applied by the collectives. ``rabit_wire_adaptive`` is
accepted and keeps the static wire gate: the JAX package's
bandwidth-learned election decides only in a world of one process,
where each of the port's groups has one rank and no wire to elect, and
keeps the static gate in a world of several, as the port does.
"""

from __future__ import annotations

import glob
import json
import os
import re
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import telemetry
from ..ops.reducers import BITOR, OP_NAMES, SUM
from ..telemetry import profile as _profile
from ..telemetry import schema as _schema
from ..tools import ARTIFACTS
from . import topology
from . import wire as _wirespec

# Fallback crossover: ring pays off above 32K elements (reference
# allreduce_base.cc:35, doc/parameters.md).
RING_MINCOUNT_DEFAULT = 32 << 10

# Fallback wire gate: the JAX package measured quantized wire losing at
# 65k and winning at 4.2M floats on its host fabric; 256K elements sits
# conservatively inside that band.
WIRE_MINCOUNT_DEFAULT = 256 << 10

METHODS = ("tree", "ring", "bidir", "swing", "hier")

# "preagg" is a valid EXPLICIT method but never a table row: sweeps
# measure steady-state schedules, and pre-aggregation only exists
# relative to a measured laggard.
EXPLICIT_METHODS = METHODS + ("preagg",)

SCHEMA_PREFIX = _schema.SCHEMA_PREFIX + "collective_sweep/"
# v3 adds block-quantized wire-spec columns ("int8:bf16", "@block") and
# the per-row wire_block field; v2 added the skew/lag columns; v1/v2
# artifacts keep loading.
SCHEMA = SCHEMA_PREFIX + "v3"
ACCEPTED_SCHEMAS = (SCHEMA, SCHEMA_PREFIX + "v2", SCHEMA_PREFIX + "v1")

_TABLE_ENV = "RABIT_DISPATCH_TABLE"
_WIRE_ENV = "RABIT_DATAPLANE_WIRE"
_WIRE_MINCOUNT_ENV = "RABIT_DATAPLANE_WIRE_MINCOUNT"

# Table wire columns may hold any canonical wire spec
# ("<rs>[:<ag>][@<block>]", parallel/wire.py grammar).
_WIRE_SPEC_RE = re.compile(
    r"^(bf16|int8|none)(:(bf16|int8|none))?(@[1-9][0-9]*)?$")


# Last wire actually applied by resolve() -- request vs outcome.
_last_wire: Optional[str] = None
_last_wire_provenance: str = ""


def note_wire(wire: Optional[str], provenance: str = "") -> None:
    global _last_wire, _last_wire_provenance
    _last_wire = wire
    _last_wire_provenance = provenance


def last_wire() -> Optional[str]:
    return _last_wire


def last_wire_provenance() -> str:
    return _last_wire_provenance


def wire_mincount() -> int:
    """Element-count floor below which a config/env-requested wire stays
    off (``rabit_dataplane_wire_mincount``; size suffixes accepted)."""
    from ..utils.config import parse_size
    v = os.environ.get(_WIRE_MINCOUNT_ENV)
    return parse_size(v) if v else WIRE_MINCOUNT_DEFAULT


def _newest_sweep() -> Optional[str]:
    """Newest sweep artifact of the port (timestamped names sort)."""
    found = sorted(glob.glob(str(ARTIFACTS / "COLLECTIVE_SWEEP_*.json")),
                   key=os.path.basename)
    return found[-1] if found else None


# the committed tables of the port (COLLECTIVE_SWEEP_*.json), read only in
# an NCCL world
TABLES = Path(__file__).resolve().parent / "tables"


def _nccl_world() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "nccl")


def _tracked_sweep() -> Optional[str]:
    """The newest committed table, where the default group is NCCL's."""
    if not _nccl_world():
        return None
    found = sorted(TABLES.glob("COLLECTIVE_SWEEP_*.json"),
                   key=lambda f: f.name)
    return str(found[-1]) if found else None


def _valid_rows(rows) -> bool:
    if not isinstance(rows, list) or not rows:
        return False
    for r in rows:
        if not isinstance(r, dict) or r.get("method") not in METHODS:
            return False
        if not (r.get("max_n") is None or isinstance(r["max_n"], int)):
            return False
        w = r.get("wire")
        if w is not None and (not isinstance(w, str)
                              or not _WIRE_SPEC_RE.match(w)):
            return False
        # "flat": the schedule a hier row degrades to on worlds without
        # a usable host grouping (optional; hier rows only)
        if r.get("flat") not in (None, "tree", "ring", "bidir", "swing"):
            return False
    return rows[-1].get("max_n") is None  # must cover every size


# path -> (mtime, table-or-None); a changed file re-parses, a bad file
# is remembered as bad until it changes
_cache: dict = {}


def clear_cache() -> None:
    _cache.clear()


def epoch_reset(world: int) -> None:
    """Membership epoch hook: the parsed table is cached per path and its
    rows steer method choice per world size, so a stale parse must not
    outlive the world that loaded it."""
    del world  # resolve() receives the new world size per call
    clear_cache()


def load_table(path: Optional[str] = None) -> Optional[dict]:
    """The dispatch table, or None (-> fallback constants).

    Resolution order: explicit ``path`` arg, ``RABIT_DISPATCH_TABLE``
    env (``none``/``off``/``0`` disables), newest
    ``COLLECTIVE_SWEEP_*.json`` under the port's ``build/artifacts/``,
    then, in an NCCL world, the newest under ``parallel/tables/``.
    A missing file, a schema outside ``ACCEPTED_SCHEMAS`` or malformed
    rows all yield None -- dispatch degrades to the documented defaults,
    never crashes. Each read of a file counts a ``dispatch_table`` hit or
    miss of the mtime cache in the profiling plane.
    """
    if path is None:
        env = os.environ.get(_TABLE_ENV)
        if env in ("none", "off", "0"):
            return None
        path = env or _newest_sweep() or _tracked_sweep()
    if not path:
        return None
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    hit = _cache.get(path)
    if hit is not None and hit[0] == mtime:
        _profile.cache_event("dispatch_table", hit=True)
        return hit[1]
    _profile.cache_event("dispatch_table", hit=False)
    table = None
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("schema") in ACCEPTED_SCHEMAS:
            cand = data.get("table")
            if (isinstance(cand, dict)
                    and _valid_rows(cand.get("float_sum"))
                    and _valid_rows(cand.get("other"))):
                table = cand
    except (OSError, ValueError):
        table = None
    _cache[path] = (mtime, table)
    return table


def _bucket(rows, n: int) -> dict:
    for r in rows:
        if r["max_n"] is None or n <= r["max_n"]:
            return r
    return rows[-1]  # unreachable for valid tables (last max_n is None)


def _is_floating(dtype) -> bool:
    """torch, numpy and string dtypes alike."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    import numpy as np
    return np.issubdtype(np.dtype(dtype), np.floating)


def _itemsize(dtype) -> int:
    """Bytes an element, for torch, numpy and string dtypes alike."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize   # no tensor: resolve adds no operation
    import numpy as np
    return np.dtype(dtype).itemsize


def resolve(n: int, dtype, op: int, axis_size: int,
            method: str = "auto",
            wire: Optional[str] = "auto",
            groups=None, skew: bool = True) -> Tuple[str, Optional[str]]:
    """Resolve ``(method, wire)`` for an ``n``-element payload over a
    world of ``axis_size`` ranks; the JAX package's contract.

    ``method="auto"``: per-size-bucket choice from the table, else tree
    below ``RING_MINCOUNT_DEFAULT`` and ring above (with the big-BitOR
    override -- the tree BitOR path all-gathers).

    ``groups`` is the resolved host grouping (``parallel/topology.py``).
    A table row saying ``hier`` only engages when the grouping is
    genuinely two-level; otherwise the row's ``flat`` column (else the
    fallback constants) applies. An EXPLICIT ``method="hier"`` on such a
    world degrades to ``ring``, the same contract as swing on a world
    that is not a power of two.

    With ``rabit_skew_adapt`` on and the fleet-agreed digest (adopted
    at the last agreement boundary; never a per-process candidate)
    naming a laggard inside this world, ``"auto"`` prefers the
    skew-tolerant shapes (swing/bidir -> tree/ring by size) and stamps
    the provenance ``skew_adapted`` and the ``dispatch.skew_adapted``
    count; the concrete re-root / rotation / pre-aggregation plan is
    applied by the collectives (``telemetry/skew.py::adapt_plan``).
    ``skew=False`` (the collectives' call over a proper sub-group, which
    plans nothing) leaves the digest unread.

    ``wire="auto"`` engages the env-requested wire (the
    ``RABIT_DATAPLANE_WIRE`` base codec composed with the
    ``rabit_wire_rs``/``rabit_wire_ag`` phase overrides and the
    ``rabit_wire_block`` block size) only where measurement says it
    pays: the table bucket's wire field, else ``n >= wire_mincount()``
    (also under ``rabit_wire_adaptive``). An explicitly configured
    mincount (the env var is set) beats the
    table's wire column. No env wire (or a tree method) -> None. An
    explicit wire spec passes through, canonicalized;
    ``wire="none"``/None force it off. The applied wire and its
    provenance are noted (:func:`note_wire`).
    """
    from ..telemetry import skew as _skew
    requested = method
    table = load_table()
    wire_eligible = op == SUM and _is_floating(dtype)
    hier_ok = (topology.hier_enabled()
               and topology.is_hierarchical(groups, axis_size))
    if method == "auto":
        if table is not None:
            rows = table["float_sum"] if wire_eligible else table["other"]
            row = _bucket(rows, n)
            method = row["method"]
            if method == "hier" and not hier_ok:
                method = row.get("flat") or (
                    "ring" if n >= RING_MINCOUNT_DEFAULT else "tree")
        else:
            method = "ring" if n >= RING_MINCOUNT_DEFAULT else "tree"
        if op == BITOR and n >= 1024 and method == "tree":
            method = "ring"  # tree BitOR all-gathers: tiny buffers only
    if method not in EXPLICIT_METHODS:
        raise ValueError(
            f"method must be one of {('auto',) + EXPLICIT_METHODS}, "
            f"got {method!r}")
    if method == "hier" and not hier_ok:
        method = "ring"  # no usable host grouping: flat ring IS the
        #                  inter-host path (degradation contract)
    if method == "swing" and axis_size & (axis_size - 1):
        method = "ring"  # swing needs a power-of-two world
    adapted = False
    if requested == "auto" and skew and _skew.adapt_enabled():
        # the fleet-AGREED digest only (never a per-process candidate,
        # which would elect different methods on different ranks); the
        # fixed-topology involutions (swing, bidir) have no good place
        # to park a laggard, while the tree re-roots and the ring
        # rotates. A laggard outside this world yields no plan
        # downstream, so provenance must not claim adaptation for it.
        lag = _skew.laggard_of(_skew.monitor().applied())
        if lag is not None and 0 <= lag < axis_size and axis_size >= 2:
            adapted = True
            if method in ("swing", "bidir"):
                method = ("tree" if n < RING_MINCOUNT_DEFAULT else "ring")
    requested_wire = wire
    if wire == "auto":
        env_wire = _wirespec.phase_request(
            os.environ.get(_WIRE_ENV) or None)
        if (env_wire is None or method in ("tree", "preagg")
                or not wire_eligible):
            wire = None
        elif table is not None and not os.environ.get(_WIRE_MINCOUNT_ENV):
            wire = env_wire \
                if _bucket(table["float_sum"], n).get("wire") else None
        else:
            wire = env_wire if n >= wire_mincount() else None
    elif wire in ("none", "off"):
        wire = None
    else:
        wire = _wirespec.canonical_wire(wire)
    provenance = ("explicit" if requested != "auto"
                  else "skew_adapted" if adapted
                  else "table" if table is not None else "fallback")
    wire_prov = "explicit" if requested_wire != "auto" else provenance
    if telemetry.enabled():
        itemsize = _itemsize(dtype)
        opname = OP_NAMES.get(op, str(op))
        if adapted:
            telemetry.count("dispatch.skew_adapted")
        if wire is not None:
            # bytes entering the quantized data plane, by spec
            telemetry.count("wire.quantized", nbytes=n * itemsize,
                            op=opname, method=method, wire=wire,
                            provenance=wire_prov)
        telemetry.record_dispatch(n, itemsize, opname, method, wire,
                                  provenance)
    note_wire(wire, wire_prov)
    return method, wire

"""Host-topology discovery and grouping for hierarchical collectives:
the port's copy of the framework-neutral
``rabit_tpu/parallel/topology.py`` (the port imports nothing of
``rabit_tpu``; ``tests/test_torch_dispatch.py`` holds this copy against
the original on the same specs).

A flat ring treats every link as equal, but links inside a host (NVLink
between the cards of one machine) are faster than links between hosts.
This module owns the *shape* of that asymmetry: which ranks share a host
(``groups``), which rank speaks for each host (``delegates``), and the
inter-host rings the reduced shards travel (``slot_rings``). The
schedules live in ``parallel/collectives.py`` (``hier_allreduce``);
policy lives in ``parallel/dispatch.py`` (``method="auto"`` consults
:func:`is_hierarchical`).

Sources of truth, strongest first:

1. an explicit ``groups=`` argument on the collective call;
2. the ``rabit_hier_group`` config knob (exported as the
   ``RABIT_HIER_GROUP`` env var) -- an operator override and the forced
   grouping used by simulated-host tests;
3. the tracker's ``topo`` wire command (:func:`fetch_topo`), which
   groups ranks by the host fingerprint observed on the endpoint
   announce path at assignment time.

``rabit_hier=0`` (``RABIT_HIER``) disables hierarchy everywhere without
touching the grouping plumbing. Everything here is plain Python.
"""

from __future__ import annotations

import json
import os
import socket
import struct
from typing import Optional, Sequence, Tuple

Groups = Tuple[Tuple[int, ...], ...]

_HIER_ENV = "RABIT_HIER"
_GROUP_ENV = "RABIT_HIER_GROUP"

_OFF = ("0", "false", "no", "off", "none")

# the tracker's wire magic (rabit_tpu/tracker/tracker.py::MAGIC)
_TRACKER_MAGIC = 0x52425401


def hier_enabled() -> bool:
    """Whether hierarchical schedules may engage at all (``rabit_hier``
    knob, exported as ``RABIT_HIER``; default on). Enabled alone does
    nothing — a usable grouping must also resolve."""
    return os.environ.get(_HIER_ENV, "1").strip().lower() not in _OFF


def normalize_groups(groups: Sequence[Sequence[int]],
                     world: int) -> Groups:
    """Validate that ``groups`` partitions ``range(world)`` — every rank
    exactly once, all in range — and freeze it into the hashable
    tuple-of-tuples the jitted schedules take as a static argument.
    Group order and in-group rank order are preserved: they define the
    intra-host and inter-host ring orders."""
    out = tuple(tuple(int(r) for r in grp) for grp in groups)
    flat = [r for grp in out for r in grp]
    if sorted(flat) != list(range(world)):
        raise ValueError(
            f"groups {out!r} must partition ranks 0..{world - 1}: every "
            "rank exactly once")
    return out


def parse_groups(spec, world: int) -> Optional[Groups]:
    """Parse a grouping spec into groups, or None (= no grouping known).

    Accepted forms:

    - ``None`` / ``""`` / ``"auto"`` / off-words -> None;
    - an int (or digit string) g: ``world`` splits into contiguous
      groups of g ranks — the common homogeneous ranks-per-host case
      (raises unless g divides world);
    - ``"0,1|2,3"``: explicit groups, ``|``-separated hosts of
      ``,``-separated ranks (the tracker export and test override form;
      non-uniform group sizes are representable — dispatch decides
      whether they are usable).
    """
    if spec is None:
        return None
    if isinstance(spec, int):
        g = spec
    else:
        spec = str(spec).strip()
        if not spec or spec.lower() in _OFF or spec.lower() == "auto":
            return None
        if spec.isdigit():
            g = int(spec)
        else:
            try:
                groups = [[int(r) for r in part.split(",") if r.strip()]
                          for part in spec.split("|") if part.strip()]
            except ValueError as e:
                raise ValueError(
                    f"bad rabit_hier_group spec {spec!r}: expected an int "
                    "group size or '0,1|2,3' explicit groups") from e
            return normalize_groups(groups, world)
    if g <= 1:
        return None
    if world % g:
        raise ValueError(
            f"rabit_hier_group={g} does not divide world size {world}")
    return tuple(tuple(range(i, i + g)) for i in range(0, world, g))


def resolve_groups(world: int, explicit=None,
                   spec=None) -> Optional[Groups]:
    """Resolve the host grouping for a ``world``-rank axis: explicit
    argument > ``spec`` > ``RABIT_HIER_GROUP`` env. Returns None when
    hierarchy is disabled (``rabit_hier=0``) or no grouping is known —
    callers then run the flat schedules unchanged."""
    if not hier_enabled():
        return None
    if explicit is not None:
        return normalize_groups(explicit, world)
    if spec is None:
        spec = os.environ.get(_GROUP_ENV)
    return parse_groups(spec, world)


def is_hierarchical(groups, world: int) -> bool:
    """True when ``groups`` describes a genuinely two-level world that
    the SPMD hierarchical schedule can run: more than one host, more
    than one rank per host, and a uniform group size (every rank must
    execute the identical program over identically shaped chunks).
    Degenerate worlds — all ranks on one host, one rank per host,
    ragged groups — return False and run a flat schedule."""
    if not groups:
        return False
    if len(groups) <= 1 or len(groups) >= world:
        return False
    return len({len(grp) for grp in groups}) == 1


def delegates(groups) -> Tuple[int, ...]:
    """The elected delegate of each host: its minimum rank. Min-rank is
    deterministic from the grouping alone, so tracker, workers, and
    tests elect identically without another round trip."""
    return tuple(min(grp) for grp in groups)


def slot_rings(groups) -> Groups:
    """The inter-host rings: slot ring j links each host's
    local-index-j rank, in host order. Ring 0 is the delegate ring;
    together the g rings ARE the host-delegate fabric — every rank
    does inter-host work for its own slot's shard, so the inter phase
    spreads over all NICs instead of serializing through one delegate.
    Requires uniform groups (:func:`is_hierarchical`)."""
    g = len(groups[0])
    return tuple(tuple(grp[j] for grp in groups) for j in range(g))


def groups_spec(groups) -> str:
    """Serialize groups into the ``"0,1|2,3"`` spec form —
    ``parse_groups``'s inverse, used to export tracker-discovered
    topology through the ``RABIT_HIER_GROUP`` env."""
    return "|".join(",".join(str(r) for r in grp) for grp in groups)


def epoch_reset(world: int) -> None:
    """Elastic-membership epoch hook (lint rule R002). The grouping
    exported through ``RABIT_HIER_GROUP`` names OLD-world ranks; after
    a resize it may not even parse for the new world (a rank beyond
    ``world``, a partition that no longer covers it). Drop it unless it
    still describes the new world exactly — the engine re-exports a
    fresh tracker-discovered grouping when the re-formed assignment
    arrives, so a dropped spec means "flat until rediscovered", never
    a crash on the survivors' first post-resize collective."""
    spec = os.environ.get(_GROUP_ENV)
    if not spec:
        return
    try:
        parse_groups(spec, int(world))
    except (ValueError, TypeError):
        os.environ.pop(_GROUP_ENV, None)


def group_by_fingerprint(fingerprints: Sequence[str]) -> Groups:
    """Group ranks sharing a host fingerprint (``fingerprints[rank]``),
    preserving rank order within each group and first-appearance order
    across groups — the tracker-side half of topology discovery."""
    order: dict = {}
    for rank, fp in enumerate(fingerprints):
        order.setdefault(fp, []).append(rank)
    return tuple(tuple(ranks) for ranks in order.values())


def fetch_topo(host: str, port: int, task_id: str = "0",
               timeout: float = 10.0) -> Optional[Groups]:
    """Pull the tracker's discovered host grouping (the ``topo`` wire
    command: magic, command, task id, attempt; one JSON string back).
    Best-effort: returns None instead of raising -- a tracker that
    predates the command, went away, or has not assigned yet must not
    break bootstrap, it just means a flat world. One connection attempt
    (the JAX package retries with backoff and merges the reply's hybrid
    logical clock; the port has neither the retry helper nor the clock
    yet)."""
    def send_u32(conn, v: int) -> None:
        conn.sendall(struct.pack("<I", v))

    def send_str(conn, s: str) -> None:
        b = s.encode()
        send_u32(conn, len(b))
        conn.sendall(b)

    def recv_all(conn, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = conn.recv(n - len(out))
            if not chunk:
                raise ConnectionError("tracker closed the connection")
            out += chunk
        return out

    try:
        with socket.create_connection((host, int(port)),
                                      timeout=timeout) as conn:
            send_u32(conn, _TRACKER_MAGIC)
            send_str(conn, "topo")
            send_str(conn, task_id)
            send_u32(conn, 0)  # num_attempt (informational)
            n = struct.unpack("<I", recv_all(conn, 4))[0]
            doc = json.loads(recv_all(conn, n).decode())
        groups = doc.get("groups")
        if not groups:
            return None
        return normalize_groups(groups, sum(len(g) for g in groups))
    except (OSError, ValueError, ConnectionError):
        return None

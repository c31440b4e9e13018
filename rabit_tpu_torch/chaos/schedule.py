"""Declarative, seeded fault schedules for the chaos proxy: the port's
copy of ``rabit_tpu/chaos/schedule.py``, whole (the same rules and
fields, the same draws for the same seed, rule and connection).

A schedule is an ordered list of :class:`Rule`\\ s plus a seed. Every
probabilistic draw is keyed ``(seed, rule_index, conn_index)`` through
its own :class:`random.Random`, so two runs with the same seed and the
same connection arrival order inject byte-identical faults — the
determinism contract the chaos unit tests pin (a flaky chaos test is
worse than no chaos test).

Rule fields (all optional except ``kind``):

========== ===========================================================
``kind``   ``delay`` | ``reset`` | ``partial`` | ``partition`` |
           ``blackout`` | ``tracker_kill`` | ``tracker_partition`` |
           ``bitflip`` | ``job_storm``
``conn``   apply only to the nth accepted connection (0-based);
           ``None`` = every connection
``prob``   apply with this probability (seeded draw); default 1.0
``max_times``  total firings across the proxy's lifetime (default
           unlimited)
``after_bytes``  trigger once this many payload bytes passed through
           the connection (both directions summed); ``reset`` closes
           both halves with RST there, ``partial`` first forwards
           ``truncate_to`` bytes of the pending chunk
``delay_ms``  ``delay``: added before forwarding each chunk
``window_s``  ``(start, end)`` seconds relative to proxy start;
           ``partition`` stalls forwarding inside the window (packets
           neither delivered nor refused — the hung-peer shape),
           ``blackout`` refuses new connections inside it (the
           tracker-restart shape), ``tracker_kill`` fires its kill
           hook on the first accept inside it (the tracker-CRASH
           shape: the proxy's upstream tracker is killed and — when a
           WAL is configured — respawned with ``--resume`` after
           ``delay_ms``; requires ``window_s`` or ``conn``, defaults
           ``max_times`` to 1), ``tracker_partition`` stalls only
           tracker-bound connections inside the window while link
           proxies keep flowing (the leader-partition shape: the data
           plane is healthy, the control plane is unreachable — what
           hot-standby failover must catch; requires ``window_s``,
           implicitly ``target="tracker"`` unless overridden);
           ``bitflip`` XORs 1-4 seeded random bytes of one forwarded
           chunk inside the window (the silent-corruption shape the
           frame-CRC data plane must reject and retransmit; requires
           ``window_s``, ``after_bytes`` or ``conn`` as an anchor,
           defaults ``max_times`` to 1, usually ``target="link"`` —
           the control-plane protocol has no CRC layer);
           ``job_storm`` opens a seeded ``burst`` of rogue control
           connections — bogus ``submit`` payloads interleaved with
           half-open ``start`` preambles — straight at the proxied
           tracker on entering the window (the thundering-herd /
           misbehaving-launcher shape admission control must shed
           without stalling live jobs; requires ``window_s``,
           implicitly ``target="tracker"``, defaults ``max_times``
           to 1)
``burst``  ``job_storm``: how many rogue connections one firing
           opens (default 8)
``target``  ``"tracker"`` | ``"link"`` | ``None`` (both, the
           default): which proxy class runs the rule. Link wiring has
           no retry around an accepted-then-reset handshake (a peer
           dying mid-wiring wedges ranks blocked in accept), so
           destructive rules usually want ``"tracker"`` scoping while
           ``"link"`` aims at established collective streams
========== ===========================================================

Specs parse from dicts, JSON strings, or ``@/path/to/file.json`` (the
``rabit_chaos`` knob accepts the same three shapes).
"""

from __future__ import annotations

import json
import random
from typing import List, Optional, Sequence, Tuple

KINDS = ("delay", "reset", "partial", "partition", "blackout",
         "tracker_kill", "tracker_partition", "bitflip", "job_storm")
TARGETS = ("tracker", "link")


class Rule:
    __slots__ = ("kind", "conn", "prob", "max_times", "after_bytes",
                 "delay_ms", "truncate_to", "window_s", "target",
                 "burst", "fired")

    def __init__(self, kind: str, conn: Optional[int] = None,
                 prob: float = 1.0, max_times: Optional[int] = None,
                 after_bytes: int = 0, delay_ms: float = 0.0,
                 truncate_to: int = 0,
                 window_s: Optional[Sequence[float]] = None,
                 target: Optional[str] = None, burst: int = 8):
        if kind not in KINDS:
            raise ValueError(f"chaos rule kind must be one of {KINDS}, "
                             f"got {kind!r}")
        if kind in ("partition", "blackout", "tracker_partition") \
                and window_s is None:
            raise ValueError(f"chaos {kind!r} rule requires window_s")
        if kind == "tracker_partition" and target is None:
            # "partition the LEADER, not the world": by construction
            # this rule stalls only tracker-bound connections — link
            # proxies never run it unless a test explicitly retargets
            target = "tracker"
        if kind == "tracker_kill":
            # the kill must be anchored (a window or a specific
            # connection) or the very FIRST accept — registration —
            # would murder the tracker before any world exists; and it
            # defaults to firing once (a respawn loop is a different
            # experiment than a crash)
            if window_s is None and conn is None:
                raise ValueError(
                    "chaos 'tracker_kill' rule requires window_s or conn")
            if max_times is None:
                max_times = 1
        if kind == "bitflip":
            # corruption must be anchored like tracker_kill — an
            # unanchored flip would corrupt the very first registration
            # bytes instead of an established collective stream — and
            # defaults to one firing (sustained corruption is a
            # different experiment than a transient fault)
            if window_s is None and conn is None and not after_bytes:
                raise ValueError("chaos 'bitflip' rule requires window_s, "
                                 "after_bytes or conn")
            if max_times is None:
                max_times = 1
        if kind == "job_storm":
            # the storm is generative (it OPENS connections instead of
            # mutating a stream), so it needs a window to anchor the
            # burst, is tracker-class by construction — link listeners
            # have no submit verb to abuse — and fires once by default
            # (a sustained storm is a different experiment than a
            # thundering herd)
            if window_s is None:
                raise ValueError("chaos 'job_storm' rule requires window_s")
            if target is None:
                target = "tracker"
            if max_times is None:
                max_times = 1
        if target is not None and target not in TARGETS:
            raise ValueError(f"chaos rule target must be one of {TARGETS} "
                             f"or None, got {target!r}")
        self.kind = kind
        self.target = target
        self.conn = conn
        self.prob = float(prob)
        self.max_times = max_times
        self.after_bytes = int(after_bytes)
        self.delay_ms = float(delay_ms)
        self.truncate_to = int(truncate_to)
        self.window_s: Optional[Tuple[float, float]] = (
            None if window_s is None
            else (float(window_s[0]), float(window_s[1])))
        self.burst = max(1, int(burst))
        self.fired = 0  # lifetime firing counter (proxy bumps it)

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        if self.conn is not None:
            d["conn"] = self.conn
        if self.prob != 1.0:
            d["prob"] = self.prob
        if self.max_times is not None:
            d["max_times"] = self.max_times
        if self.after_bytes:
            d["after_bytes"] = self.after_bytes
        if self.delay_ms:
            d["delay_ms"] = self.delay_ms
        if self.truncate_to:
            d["truncate_to"] = self.truncate_to
        if self.window_s is not None:
            d["window_s"] = list(self.window_s)
        if self.target is not None:
            d["target"] = self.target
        if self.burst != 8:
            d["burst"] = self.burst
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        known = {"kind", "conn", "prob", "max_times", "after_bytes",
                 "delay_ms", "truncate_to", "window_s", "target", "burst"}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown chaos rule field(s) {sorted(extra)}")
        return cls(**d)


class Schedule:
    """Seeded rule set. ``decide(conn_index)`` resolves, without any
    shared-RNG ordering hazards, which rules apply to that connection."""

    def __init__(self, rules: Sequence[Rule] = (), seed: int = 0):
        self.rules: List[Rule] = list(rules)
        self.seed = int(seed)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_spec(cls, spec) -> "Schedule":
        """dict / JSON string / ``@file.json`` / Schedule passthrough /
        None -> empty schedule."""
        if spec is None:
            return cls()
        if isinstance(spec, Schedule):
            return spec
        if isinstance(spec, str):
            if spec.startswith("@"):
                with open(spec[1:]) as f:
                    spec = json.load(f)
            else:
                spec = json.loads(spec)
        if not isinstance(spec, dict):
            raise ValueError(
                f"chaos spec must be a dict, got {type(spec).__name__}")
        rules = [Rule.from_dict(r) for r in spec.get("rules", [])]
        return cls(rules, seed=int(spec.get("seed", 0)))

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [r.to_dict() for r in self.rules]})

    def reseed(self, salt: int) -> "Schedule":
        """An independent same-rules schedule (fresh ``fired`` counters)
        for another proxy in the same run — per-target determinism
        without cross-proxy counter sharing."""
        return Schedule([Rule.from_dict(r.to_dict()) for r in self.rules],
                        seed=self.seed + int(salt))

    def for_target(self, target: str) -> "Schedule":
        """The sub-schedule a ``target``-class proxy should run: rules
        scoped to that target plus unscoped (``target=None``) rules.
        Rule identity is preserved (no copy), so rule indices shift —
        pair with :meth:`reseed` (which copies) before handing the
        result to a proxy, as ``_ChaosFarm`` does."""
        if target not in TARGETS:
            raise ValueError(f"chaos target must be one of {TARGETS}, "
                             f"got {target!r}")
        return Schedule([r for r in self.rules
                         if r.target is None or r.target == target],
                        seed=self.seed)

    # -- resolution -------------------------------------------------------
    def _drawn(self, rule_idx: int, conn_index: int) -> bool:
        rule = self.rules[rule_idx]
        if rule.prob >= 1.0:
            return True
        # explicit integer key: tuple seeding would ride hash(), which
        # is only deterministic for ints — keep the contract visible
        key = (self.seed * 1_000_003 + rule_idx) * 1_000_003 + conn_index
        return random.Random(key).random() < rule.prob

    def decide(self, conn_index: int) -> List[Rule]:
        """Rules that apply to the ``conn_index``-th accepted
        connection. ``max_times`` budgeting happens at fire time (the
        proxy calls :meth:`consume`), since a selected rule may never
        trigger (e.g. ``after_bytes`` beyond the transfer size)."""
        out = []
        for i, rule in enumerate(self.rules):
            if rule.conn is not None and rule.conn != conn_index:
                continue
            if rule.max_times is not None and rule.fired >= rule.max_times:
                continue
            if not self._drawn(i, conn_index):
                continue
            out.append(rule)
        return out

    @staticmethod
    def consume(rule: Rule) -> bool:
        """Try to spend one firing of ``rule``; False when its
        ``max_times`` budget is already gone (another connection beat
        this one to it)."""
        if rule.max_times is not None and rule.fired >= rule.max_times:
            return False
        rule.fired += 1
        return True

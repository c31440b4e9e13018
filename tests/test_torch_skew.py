"""The port's skew plane (``rabit_tpu_torch/telemetry/skew.py``, the skew
branches of ``parallel/dispatch.py`` and ``parallel/collectives.py``, the
engines' knobs) against the JAX package's:

* the copied policy -- ``SkewEstimator``, ``FleetElection`` fold
  sequences, ``digest_from_snapshot``, ``parse_digest``, the agreement
  vector's ``encode_digest``/``decode_digest`` through float32 transport
  (an epoch of 2^24 and past it), ``adapt_plan`` over worlds 2-8 x every
  method x digests with and without a laggard and a root, the knobs, the
  dispatch counter -- equal to ``rabit_tpu.telemetry.skew`` on the same
  inputs;
* ``dispatch.resolve``'s method, wire and provenance with the knob on and
  off; under ``rabit_wire_adaptive`` the static wire gate, as JAX's in a
  multi-process world;
* the tracker's ``skew`` command: the JAX tracker's reply bytes for the
  same state, and the monitor's poller over the port's tracker;
* gloo worlds of 2 and 4: every adapted schedule bit for bit against the
  flat run on integer-valued payloads and against JAX's
  ``device_allreduce`` (and its reduce-scatter and all-gather) with the
  same forced digest on the virtual CPU mesh, with the same plan;
  divergent candidates reconciled to rank 0's; with the knob unset no
  broadcast and no counter advance; ``TorchEngine``'s span tag; at world
  4, calls over sub-groups with divergent candidates plan nothing;
* the engines: the knobs exported and undone, garbage refused, the hot
  standby refused.

The module imports neither JAX nor ``rabit_tpu`` at its top: the spawned
ranks import it.
"""

import json
import os
import socket
import struct
import time

import numpy as np
import pytest
import torch

from rabit_tpu_torch.ops.reducers import MAX, MIN, SUM
from rabit_tpu_torch.parallel import dispatch as td
from rabit_tpu_torch.telemetry import skew as ts
from rabit_tpu_torch.tools import run_world

WORLD_TIMEOUT_S = 150
SKEW_ENV = ("RABIT_SKEW_ADAPT", "RABIT_SKEW_DIGEST", "RABIT_SKEW_PREAGG_MS",
            "RABIT_SKEW_POLL_MS", "RABIT_SKEW_SYNC_ROUNDS",
            "RABIT_SKEW_TRACKER", "RABIT_TRACKER_STANDBY", "RABIT_HIER",
            "RABIT_HIER_GROUP", "RABIT_DATAPLANE_WIRE",
            "RABIT_DATAPLANE_WIRE_MINCOUNT", "RABIT_WIRE_ADAPTIVE",
            "RABIT_WIRE_BLOCK", "RABIT_WIRE_RS", "RABIT_WIRE_AG")


def _js():
    from rabit_tpu.telemetry import skew
    return skew


@pytest.fixture
def clean(monkeypatch):
    """No skew, wire or topology knob set, no dispatch table, and both
    packages' monitors and counters fresh."""
    for k in SKEW_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RABIT_DISPATCH_TABLE", "none")
    js = _js()
    ts.reset_monitor()
    js.reset_monitor()
    td.clear_cache()
    yield monkeypatch
    ts.reset_monitor()
    js.reset_monitor()
    td.clear_cache()


def _digest(world: int, lag, epoch: int = 1, spread: float = 40.0,
            root=None) -> dict:
    offs = {str(r): (spread if r == lag else 0.5 * r)
            for r in range(world)}
    if root is not None:
        offs[str(root)] = -1.0
    return {"epoch": epoch, "offsets_ms": offs, "laggard": lag}


# ------------------------------------------------------------ the copies


def _raw_sequence(seed: int) -> list:
    """Sweep digests as the tracker's poll loop folds them: noisy offsets
    of 4 ranks, the laggard moving from rank 2 to rank 0 half way, ties
    (laggard None) and empty sweeps (None) among them."""
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(40):
        if rng.random() < 0.1:
            seq.append(None)
            continue
        lag = 2 if i < 20 else 0
        offs = {str(r): float(rng.normal(3.0, 2.0)) for r in range(4)}
        offs[str(lag)] = float(rng.normal(30.0, 8.0))
        tie = rng.random() < 0.15
        seq.append({"epoch": 0, "offsets_ms": offs,
                    "laggard": None if tie else lag})
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimator_and_election_fold_like_jax(seed):
    js = _js()
    seq = _raw_sequence(seed)
    ests = (ts.SkewEstimator(alpha=0.3, hysteresis_ms=5.0),
            js.SkewEstimator(alpha=0.3, hysteresis_ms=5.0))
    els = (ts.FleetElection(), js.FleetElection())
    for raw in seq:
        if raw is not None:
            for e in ests:
                e.update(raw["offsets_ms"])
            assert ests[0].offsets_ms() == ests[1].offsets_ms()
            assert ests[0].laggard == ests[1].laggard
            assert ests[0].skew_ms() == ests[1].skew_ms()
        served = [el.fold(raw) for el in els]
        assert served[0] == served[1], raw
    last = els[0].fold(None)
    for rebuilt in (ts.FleetElection.seeded(last),
                    js.FleetElection.seeded(last)):
        assert rebuilt.fold(None) == last
    for el in els:
        el.evict(0)
    assert els[0].fold(None) == els[1].fold(None)
    with pytest.raises(ValueError):
        ts.SkewEstimator(alpha=0.0)


def _summary(rank: int, count: int, busy: float) -> dict:
    from rabit_tpu_torch.telemetry import schema
    doc = schema.make_header("telemetry_summary")
    doc.update({"rank": rank, "counters": [
        {"name": "engine.allreduce", "count": count, "total_s": busy,
         "max_s": busy / max(count, 1)},
        {"name": "dispatch", "count": 99, "total_s": 5.0, "max_s": 1.0}]})
    return doc


SNAPSHOTS = {
    "busy_skew": {"0": (12, 3.1), "1": (12, 2.9), "2": (12, 0.4)},
    "round_lag": {"0": (12, 0.3), "1": (11, 0.2), "2": (12, 0.2)},
    "tie": {"0": (12, 0.5), "1": (12, 0.4), "2": (12, 0.45)},
    "one_rank": {"0": (3, 0.1)},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_snapshot_and_digest_like_jax(name):
    from rabit_tpu.telemetry import crossrank as jc
    from rabit_tpu_torch.telemetry import crossrank as tc
    js = _js()
    sums = {t: _summary(int(t), c, b) for t, (c, b) in SNAPSHOTS[name].items()}
    snap = tc.straggler_snapshot(sums)
    assert snap == jc.straggler_snapshot(sums)
    for epoch in (0, 3):
        assert ts.digest_from_snapshot(snap, epoch) == \
            js.digest_from_snapshot(snap, epoch)
    d = ts.digest_from_snapshot(snap, 1)
    assert ts.parse_digest(d) == js.parse_digest(d)


@pytest.mark.parametrize("doc", [
    None, [], {}, {"offsets_ms": []}, {"offsets_ms": {"a": 1}},
    {"offsets_ms": {"0": 1.0}, "laggard": 3},
    {"offsets_ms": {"0": 1.0, "1": "x"}},
    {"offsets_ms": {"0": 1.0, "1": 2.0}, "laggard": "1", "epoch": "4"},
    {"offsets_ms": {"0": 1.0}, "epoch": None}])
def test_parse_digest_like_jax(doc):
    assert ts.parse_digest(doc) == _js().parse_digest(doc)


@pytest.mark.parametrize("epoch", [0, 7, (1 << 24) - 1, 1 << 24,
                                   (1 << 24) + 1])
def test_agreement_vector_roundtrip_like_jax(epoch):
    """``encode_digest`` -> float32 -> ``decode_digest`` on both sides at
    worlds 2-8 and every laggard. The vector travels as float32, so an
    epoch past 2^24 rounds to an even neighbour, in both packages alike
    (the limit is kept, not repaired)."""
    js = _js()
    for world in range(2, 9):
        for lag in list(range(world)) + [None]:
            d = _digest(world, lag, epoch=epoch)
            enc = ts.encode_digest(d, world)
            assert enc == js.encode_digest(d, world)
            vec = np.asarray(enc, np.float32)
            got = ts.decode_digest(vec)
            assert got == js.decode_digest(vec)
            want_epoch = int(np.float32(epoch))
            assert got["epoch"] == want_epoch
            if epoch <= 1 << 24:
                assert want_epoch == epoch
            assert got["laggard"] == lag
            if lag is not None:
                assert ts.earliest_of(got, world) == \
                    ts.earliest_of(ts.parse_digest(d), world)
    assert ts.decode_digest(ts.encode_digest(None, 4)) is None
    assert ts.decode_digest([1.0, 1.0]) is None


PLAN_METHODS = ("tree", "ring", "bidir", "swing", "hier", "preagg", "auto")


@pytest.mark.parametrize("world", range(2, 9))
def test_adapt_plan_like_jax(clean, world):
    js = _js()
    digests = [None, {}, _digest(world, None), _digest(world, 0),
               _digest(world, world - 1), _digest(world, world // 2,
                                                  root=world - 1),
               {"epoch": 2, "offsets_ms": {str(world - 1): 9.0},
                "laggard": world - 1},
               _digest(world + 2, world + 1)]
    halves = (tuple(range(world // 2)), tuple(range(world // 2, world)))
    for preagg in (None, "0", "0.0001", "2.0"):
        if preagg is None:
            clean.delenv("RABIT_SKEW_PREAGG_MS", raising=False)
        else:
            clean.setenv("RABIT_SKEW_PREAGG_MS", preagg)
        for method in PLAN_METHODS:
            for d in digests:
                for op in ("sum", "max"):
                    for nbytes in (64, 8 << 20):
                        for groups in (None, halves):
                            kw = dict(groups=groups,
                                      digest=ts.parse_digest(d))
                            got = ts.adapt_plan(method, world, nbytes, op,
                                                **kw)
                            want = js.adapt_plan(method, world, nbytes, op,
                                                 **kw)
                            assert got == want, (method, d, op, nbytes)


def test_plan_helpers_like_jax():
    js = _js()
    for world in range(2, 9):
        for lag in range(world):
            assert ts.rotation_order(world, lag) == \
                js.rotation_order(world, lag)
            assert ts.rotation_groups(world, lag) == \
                js.rotation_groups(world, lag)
            assert ts.preagg_groups(world, lag) == \
                js.preagg_groups(world, lag)
            for root in range(world):
                if root != lag:
                    assert ts.preagg_groups(world, lag, root) == \
                        js.preagg_groups(world, lag, root)
            groups = ((0, 1), tuple(range(2, world))) if world > 3 \
                else ((0,), tuple(range(1, world)))
            assert ts.demote_delegate(groups, lag) == \
                js.demote_delegate(groups, lag)
            d = ts.parse_digest(_digest(world, lag))
            assert ts.earliest_of(d, world) == js.earliest_of(d, world)
            assert ts.skew_ms_of(d) == js.skew_ms_of(d)
    for mod in (ts, js):
        with pytest.raises(ValueError):
            mod.rotation_order(4, 4)
        with pytest.raises(ValueError):
            mod.preagg_groups(4, 1, root=1)


@pytest.mark.parametrize("var,values", [
    ("RABIT_SKEW_PREAGG_MS", ["", "0", "3.5", "-1", "x"]),
    ("RABIT_SKEW_POLL_MS", ["", "20", "100", "2500", "1.5"]),
    ("RABIT_SKEW_SYNC_ROUNDS", ["", "0", "1", "32", "x"]),
    ("RABIT_SKEW_ADAPT", ["", "0", "1", "true", "On", "no"])])
def test_knobs_like_jax(clean, var, values):
    js = _js()
    fns = {"RABIT_SKEW_PREAGG_MS": "preagg_ms_per_mib",
           "RABIT_SKEW_POLL_MS": "poll_interval_s",
           "RABIT_SKEW_SYNC_ROUNDS": "sync_rounds",
           "RABIT_SKEW_ADAPT": "adapt_enabled"}
    for v in values:
        clean.setenv(var, v)
        got = []
        for mod in (ts, js):
            try:
                got.append(getattr(mod, fns[var])())
            except ValueError:
                got.append("ValueError")
        assert got[0] == got[1], (var, v)


def test_sync_due_and_resets_like_jax(clean):
    js = _js()
    clean.setenv("RABIT_SKEW_SYNC_ROUNDS", "3")
    for mod in (ts, js):
        mod.reset_monitor()
    seqs = [[mod.sync_due() for _ in range(7)] for mod in (ts, js)]
    assert seqs[0] == seqs[1] == [True, False, False] * 2 + [True]
    for mod in (ts, js):
        mod.monitor().set_applied({"epoch": 1, "offsets_ms": {},
                                   "laggard": None})
        mod.note_applied("rotate@1")
        mod.reset_sync()
        assert mod.monitor().applied() is None and mod.sync_due()
        mod.epoch_reset(4)
        assert mod.last_applied() is None and mod.monitor().current() is None


def test_monitor_gates_tracker_candidate_until_agreement(clean):
    """A tracker's digest is a candidate only; a forced one is eligible
    before the first boundary (both packages)."""
    js = _js()
    d = _digest(4, 2)
    for mod in (ts, js):
        mon = mod.monitor()
        mon.observe(d)
        assert mon.current() == mod.parse_digest(d)
        assert mon.applied() is None
        mon.set_applied(mon.current())
        assert mon.applied() == mod.parse_digest(d)
    clean.setenv("RABIT_SKEW_DIGEST", json.dumps(_digest(4, 1)))
    for mod in (ts, js):
        mod.reset_monitor()
        assert mod.monitor().applied() == mod.parse_digest(_digest(4, 1))


# -------------------------------------------------- dispatch.resolve


RESOLVE_CASES = [
    # (knob, digest laggard, world, n, dtype, method)
    (False, 2, 4, 2048, "float32", "auto"),
    (True, 2, 4, 2048, "float32", "auto"),
    (True, 2, 4, 65536, "float32", "auto"),
    (True, 2, 4, 65536, "int32", "auto"),
    (True, 5, 4, 65536, "float32", "auto"),
    (True, None, 4, 65536, "float32", "auto"),
    (True, 1, 4, 65536, "float32", "ring"),
    (True, 1, 4, 65536, "float32", "preagg"),
    (True, 0, 1, 65536, "float32", "auto"),
    (True, 1, 2, 2048, "float32", "auto"),
]


@pytest.mark.parametrize("case", RESOLVE_CASES,
                         ids=[f"{'on' if c[0] else 'off'}-lag{c[1]}-p{c[2]}-"
                              f"{c[3]}-{c[4]}-{c[5]}" for c in RESOLVE_CASES])
def test_resolve_with_the_skew_knob_like_jax(clean, case):
    """Method, wire and provenance (the ``dispatch`` row and the
    ``dispatch.skew_adapted`` count) with a forced digest, the knob on or
    off, an env wire requested."""
    from rabit_tpu import telemetry as jtel
    from rabit_tpu.parallel import dispatch as jd
    from rabit_tpu_torch import telemetry as ttel
    knob, lag, world, n, dt, method = case
    if knob:
        clean.setenv("RABIT_SKEW_ADAPT", "1")
    clean.setenv("RABIT_SKEW_DIGEST", json.dumps(_digest(max(world, 6), lag)))
    clean.setenv("RABIT_DATAPLANE_WIRE", "bf16")
    clean.setenv("RABIT_DATAPLANE_WIRE_MINCOUNT", "4096")
    _js().reset_monitor()
    ts.reset_monitor()
    jd.clear_cache()
    rows = []
    try:
        for tel, mod, dtype in ((ttel, td, getattr(torch, dt)),
                                (jtel, jd, np.dtype(dt))):
            tel.reset(capacity=256, enabled=True)
            got = mod.resolve(n, dtype, SUM, world, method=method)
            counters = tel.snapshot()["counters"]
            rows.append((got, mod.last_wire_provenance(),
                         sorted(c["provenance"] for c in counters
                                if c["name"] == "dispatch"),
                         sum(c["count"] for c in counters
                             if c["name"] == "dispatch.skew_adapted")))
    finally:
        ttel.reset(enabled=False)
        jtel.reset(enabled=False)
    assert rows[0] == rows[1]


def _seed_bandwidth(tel, dur_s: float) -> None:
    for _ in range(5):
        tel.record_span("allreduce", dur_s, nbytes=8 << 20, op="sum",
                        method="ring")


@pytest.mark.parametrize("dur_s", [0.0005, 0.02, 0.5])
def test_adaptive_wire_knob_keeps_the_static_gate(clean, dur_s):
    """``rabit_wire_adaptive`` keeps the static wire gate. On counter rows
    on which JAX's one-process election decides, the port's ``resolve``
    with the knob on gives the wire and provenance of the port's with it
    off and of JAX's in a multi-process world (where its election returns
    no decision); neither counts a ``dispatch.wire_adapted`` row."""
    import jax
    from rabit_tpu import telemetry as jtel
    from rabit_tpu.parallel import dispatch as jd
    from rabit_tpu_torch import telemetry as ttel
    clean.setenv("RABIT_DATAPLANE_WIRE", "int8")
    jd.clear_cache()
    try:
        for tel in (ttel, jtel):
            tel.reset(capacity=256, enabled=True)
            _seed_bandwidth(tel, dur_s)
        assert jd._adaptive_elect(1 << 20, 4, "int8") is not None
        clean.setattr(jax, "process_count", lambda: 2)
        for n in (4096, 1 << 16, 1 << 20, 1 << 24):
            clean.delenv("RABIT_WIRE_ADAPTIVE", raising=False)
            static = (td.resolve(n, torch.float32, SUM, 4),
                      td.last_wire_provenance())
            clean.setenv("RABIT_WIRE_ADAPTIVE", "1")
            got = [(mod.resolve(n, dt, SUM, 4), mod.last_wire_provenance())
                   for mod, dt in ((td, torch.float32), (jd, np.float32))]
            assert got[0] == got[1] == static, n
        for tel in (ttel, jtel):
            assert not [c for c in tel.snapshot()["counters"]
                        if c["name"] == "dispatch.wire_adapted"]
    finally:
        ttel.reset(enabled=False)
        jtel.reset(enabled=False)


# ----------------------------------------------- the tracker's command


def _raw_reply(host: str, port: int, cmd: str) -> bytes:
    with socket.create_connection((host, port), timeout=5) as s:
        s.sendall(struct.pack("<I", 0x52425401))
        for word in (cmd, "0"):
            b = word.encode()
            s.sendall(struct.pack("<I", len(b)) + b)
        s.sendall(struct.pack("<I", 0))
        n = struct.unpack("<I", s.recv(4, socket.MSG_WAITALL))[0]
        return s.recv(n, socket.MSG_WAITALL)


def test_skew_command_replies_the_jax_bytes(clean):
    from rabit_tpu.tracker.tracker import Tracker as JTracker
    from rabit_tpu_torch.tracker.tracker import Tracker as TTracker
    js = _js()
    trackers = (TTracker(1, ready_timeout=5.0).start(),
                JTracker(1, ready_timeout=5.0).start())
    try:
        for digest in ({}, {"epoch": 4, "offsets_ms": {"0": 0.0, "1": 12.5},
                            "laggard": 1},
                       {"epoch": 9, "offsets_ms": {"2": 3.25}, "laggard": None}):
            replies = []
            for tr in trackers:
                with tr._lock:
                    tr._skew = dict(digest)
                replies.append(_raw_reply(tr.host, tr.port, "skew"))
            assert replies[0] == replies[1] == json.dumps(digest).encode()
            got = ts.fetch_skew(trackers[0].host, trackers[0].port)
            assert got == js.fetch_skew(trackers[1].host, trackers[1].port)
            assert got == (ts.parse_digest(digest) if digest else None)
    finally:
        for tr in trackers:
            tr.stop()


def test_monitor_poller_over_the_port_tracker(clean):
    """The poller fetches the tracker's digest off the dispatch path; a
    dead tracker costs the caller nothing and trips the breaker."""
    from rabit_tpu_torch.tracker.tracker import Tracker
    tr = Tracker(1, ready_timeout=5.0).start()
    try:
        with tr._lock:
            tr._skew = _digest(3, 2, epoch=5)
        clean.setenv("RABIT_SKEW_POLL_MS", "100")
        clean.setenv("RABIT_SKEW_TRACKER", f"{tr.host}:{tr.port}")
        ts.reset_monitor()
        deadline = time.monotonic() + 10
        while ts.monitor().current() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ts.monitor().current() == ts.parse_digest(_digest(3, 2, 5))
        assert ts.monitor().applied() is None   # a candidate only
    finally:
        tr.stop()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    clean.setenv("RABIT_SKEW_TRACKER", f"127.0.0.1:{dead}")
    ts.reset_monitor()
    t0 = time.monotonic()
    for _ in range(20):
        assert ts.monitor().current() is None
    assert time.monotonic() - t0 < 1.0
    deadline = time.monotonic() + 10
    while not ts.monitor().breaker_state()["tripped"] \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ts.monitor().breaker_state()["tripped"]


# ------------------------------------------ gloo worlds of 2 and 4


def _lag_of(p: int) -> int:
    return 2 if p > 2 else 1


def _payloads(rank: int) -> dict:
    rng = np.random.default_rng(1300)
    out = {}
    for n in (4096, 40008):
        ints = rng.integers(-60, 60, (4, n))
        out[f"f32_{n}"] = ints.astype(np.float32)[rank]
        out[f"i32_{n}"] = (ints * 3).astype(np.int32)[rank]
    return out


H22 = ((0, 1), (2, 3))


def _cases(p: int) -> dict:
    """name -> (entry point, kwargs, preagg threshold, payload keys)."""
    c = {}
    for key in ("f32_4096", "i32_4096", "f32_40008", "i32_40008"):
        for m in ("auto", "tree", "ring", "bidir", "swing"):
            c[f"allreduce_{m}_{key}"] = ("allreduce", {"method": m}, "0",
                                         key)
        c[f"allreduce_preagg_auto_{key}"] = ("allreduce", {}, "0.0001", key)
        c[f"allreduce_max_auto_{key}"] = ("allreduce", {"op": MAX}, "0.0001",
                                          key)
        for op, name in ((SUM, "sum"), (MAX, "max"), (MIN, "min")):
            c[f"preagg_{name}_{key}"] = ("allreduce",
                                         {"op": op, "method": "preagg",
                                          "groups": "preagg"}, "0", key)
        c[f"async_{key}"] = ("device_allreduce_async", {}, "0", key)
        if p == 4:
            c[f"hier_{key}"] = ("allreduce", {"method": "hier",
                                              "groups": H22}, "0", key)
            c[f"device_hier_{key}"] = ("device_hier_allreduce",
                                       {"groups": H22}, "0", key)
    for key in ("f32_4096", "i32_4096"):
        c[f"rs_{key}"] = ("device_reduce_scatter", {}, "0", key)
        c[f"ag_{key}"] = ("device_allgather", {}, "0", key)
        c[f"grad_bucket_{key}"] = ("grad_bucket_allreduce_async", {}, "0",
                                   key)
    c["bucket_async_tree"] = ("bucket_allreduce_async", {}, "0",
                              "f32_40008,i32_4096")
    return c


def _call(C, fn: str, kw: dict, rows: dict, keys: str, p: int):
    kw = dict(kw)
    if kw.get("groups") == "preagg":
        kw["groups"] = ts.preagg_groups(p, _lag_of(p))
    if "," in keys:
        tree = {k: rows[k] for k in keys.split(",")}
        return C.bucket_allreduce_async(tree, None, SUM).wait()
    out = getattr(C, fn)(rows[keys], None, **kw)
    return out.wait() if hasattr(out, "wait") else out


def _flatten_out(name: str, out) -> dict:
    if isinstance(out, dict):
        return {f"{name}|{k}": v.numpy() for k, v in out.items()}
    return {name: out.numpy()}


def _set_adapt(on: bool, preagg: str, p: int, lag: int, epoch: int = 1):
    for k in ("RABIT_SKEW_ADAPT", "RABIT_SKEW_DIGEST", "RABIT_SKEW_PREAGG_MS"):
        os.environ.pop(k, None)
    if on:
        os.environ["RABIT_SKEW_ADAPT"] = "1"
        os.environ["RABIT_SKEW_PREAGG_MS"] = preagg
        os.environ["RABIT_SKEW_DIGEST"] = json.dumps(
            _digest(p, lag, epoch=epoch))
    ts.reset_monitor()


def _adapted_rank(rank: int, p: int, device) -> dict:
    import torch.distributed as dist
    from rabit_tpu_torch import telemetry
    from rabit_tpu_torch.parallel import collectives as C
    os.environ["RABIT_DISPATCH_TABLE"] = "none"
    lag = _lag_of(p)
    rows = {k: torch.from_numpy(v) for k, v in _payloads(rank).items()}
    broadcasts = []
    real_broadcast = dist.broadcast

    def counting_broadcast(*a, **kw):
        broadcasts.append(1)
        return real_broadcast(*a, **kw)
    dist.broadcast = counting_broadcast
    got = {}
    try:
        # the knob unset, a digest present: no broadcast, no counter
        _set_adapt(False, "0", p, lag)
        os.environ["RABIT_SKEW_DIGEST"] = json.dumps(_digest(p, lag))
        for name, (fn, kw, _, keys) in _cases(p).items():
            got.update(_flatten_out(f"flat|{name}",
                                    _call(C, fn, kw, rows, keys, p)))
        got["inert"] = np.array([len(broadcasts), ts._dispatch_round,
                                 int(ts.last_applied() is None)])
        # the knob on: every case adapted, one boundary a case
        # (RABIT_SKEW_SYNC_ROUNDS 1), the tag it ran
        os.environ["RABIT_SKEW_SYNC_ROUNDS"] = "1"
        tags = []
        for name, (fn, kw, preagg, keys) in _cases(p).items():
            _set_adapt(True, preagg, p, lag)
            ts.note_applied(None)
            before = len(broadcasts)
            got.update(_flatten_out(f"adapted|{name}",
                                    _call(C, fn, kw, rows, keys, p)))
            tags.append(f"{name}={ts.last_applied()}:"
                        f"{len(broadcasts) - before}")
        got["tags"] = np.array(tags)
        # divergent candidates: each rank accuses itself; the boundary
        # hands every rank rank 0's (epoch past 2^24: float32 transport)
        _set_adapt(True, "0", p, rank, epoch=(1 << 24) + 1)
        os.environ["RABIT_SKEW_DIGEST"] = json.dumps(
            _digest(p, rank, epoch=(1 << 24) + 1))
        os.environ["RABIT_SKEW_SYNC_ROUNDS"] = "32"
        ts.reset_monitor()
        ts.monitor().current()
        os.environ.pop("RABIT_SKEW_DIGEST")   # a tracker candidate now
        x = rows["i32_40008"]
        got["divergent"] = C.allreduce(x, None, SUM, method="ring").numpy()
        applied = ts.monitor().applied()
        got["divergent_tag"] = np.array(str(ts.last_applied()))
        got["divergent_applied"] = np.array(
            [applied["laggard"], applied["epoch"]])
        # TorchEngine adopts the world: its round span carries the tag
        from rabit_tpu_torch.engine.torch_engine import TorchEngine
        _set_adapt(True, "0", p, lag)
        telemetry.reset(capacity=256, enabled=True)
        eng = TorchEngine()
        eng.init(["rabit_device=cpu", "rabit_telemetry=1"])
        buf = _payloads(rank)["f32_40008"].copy()
        eng.allreduce(buf, SUM)
        spans = [s for s in telemetry.snapshot()["spans"]
                 if s["name"] == "engine.allreduce"]
        got["engine_tag"] = np.array(str(spans[-1]["attrs"].get("adapted")))
        got["engine_out"] = buf
        eng.shutdown()
        telemetry.reset(enabled=False)
    finally:
        dist.broadcast = real_broadcast
        os.environ.pop("RABIT_SKEW_SYNC_ROUNDS", None)
        _set_adapt(False, "0", p, lag)
    return got


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    p = request.param
    return p, run_world(_adapted_rank, p, "cpu", timeout_s=WORLD_TIMEOUT_S,
                        arrays=True,
                        tmp=str(tmp_path_factory.mktemp(f"skew{p}")))


def _jax_tag_and_out(p: int, name: str):
    """The same case through the JAX package on a p-device slice of the
    virtual mesh, the same forced digest: (result, plan tag)."""
    from rabit_tpu.parallel import collectives as JC
    from rabit_tpu.parallel import make_mesh
    from rabit_tpu.parallel.collectives import shard_over
    js = _js()
    fn, kw, preagg, key = _cases(p)[name]
    jfn = {"allreduce": "device_allreduce"}.get(fn, fn)
    kw = dict(kw)
    if kw.get("groups") == "preagg":
        kw["groups"] = js.preagg_groups(p, _lag_of(p))
    mesh = make_mesh(p)
    xs = np.stack([_payloads(r)[key] for r in range(p)])
    os.environ["RABIT_DISPATCH_TABLE"] = "none"   # as the ranks
    os.environ["RABIT_SKEW_ADAPT"] = "1"
    os.environ["RABIT_SKEW_PREAGG_MS"] = preagg
    os.environ["RABIT_SKEW_DIGEST"] = json.dumps(_digest(p, _lag_of(p)))
    js.reset_monitor()
    try:
        out = np.asarray(getattr(JC, jfn)(shard_over(mesh, xs), mesh, **kw))
        return out, js.last_applied()
    finally:
        for k in ("RABIT_SKEW_ADAPT", "RABIT_SKEW_PREAGG_MS",
                  "RABIT_SKEW_DIGEST", "RABIT_DISPATCH_TABLE"):
            os.environ.pop(k, None)
        js.reset_monitor()


def test_adapted_schedules_equal_the_flat_run(world):
    p, ranks = world
    lag = _lag_of(p)
    for r, got in enumerate(ranks):
        for key, flat in got.items():
            if not key.startswith("flat|"):
                continue
            name = key[len("flat|"):]
            adapted = got["adapted|" + name]
            assert adapted.dtype == flat.dtype and \
                adapted.tobytes() == flat.tobytes(), (p, r, name)
            assert flat.tobytes() == ranks[0][key].tobytes() or \
                name.startswith("rs_"), (p, r, name)
        tags = dict(t.rsplit("=", 1) for t in got["tags"].tolist())
        for name, tag in tags.items():
            plan, bcasts = tag.rsplit(":", 1)
            assert bcasts == "1", (p, name, tag)   # one boundary a call
            if name.startswith(("grad_bucket", "bucket_async")):
                assert plan == "None", (name, plan)  # no plan: explicit
            elif name.startswith("preagg_"):
                assert plan == "None", (name, plan)
            else:
                assert plan.endswith(f"@{lag}"), (name, plan)
        assert tags == dict(t.rsplit("=", 1)
                            for t in ranks[0]["tags"].tolist())
    # the ring family rotated, the tree re-rooted, SUM pre-aggregated
    tags = dict(t.rsplit("=", 1) for t in ranks[0]["tags"].tolist())
    assert tags["allreduce_ring_f32_4096"] == f"rotate@{lag}:1"
    assert tags["allreduce_tree_i32_4096"] == f"tree_reroot@{lag}:1"
    assert tags["allreduce_preagg_auto_f32_40008"] == f"preagg@{lag}:1"
    assert tags["rs_f32_4096"] == f"rotate@{lag}:1"


def test_adapted_schedules_match_jax(world):
    p, ranks = world
    tags = dict(t.rsplit("=", 1) for t in ranks[0]["tags"].tolist())
    for name, (fn, _, _, key) in sorted(_cases(p).items()):
        if fn not in ("allreduce", "device_reduce_scatter",
                      "device_allgather", "device_hier_allreduce"):
            continue
        want, jtag = _jax_tag_and_out(p, name)
        got = ranks[0]["adapted|" + name]
        if fn == "device_reduce_scatter":
            got = np.concatenate([r["adapted|" + name] for r in ranks])
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), \
            (p, name)
        assert tags[name].rsplit(":", 1)[0] == str(jtag), (p, name, jtag)


def test_divergent_candidates_reconcile_to_rank_0(world):
    p, ranks = world
    want = np.stack([_payloads(r)["i32_40008"] for r in range(p)]).sum(0)
    for r, got in enumerate(ranks):
        assert got["divergent"].tobytes() == want.astype(np.int32).tobytes()
        assert str(got["divergent_tag"]) == "rotate@0", (r, got)
        # rank 0's candidate, its epoch through float32 transport
        assert got["divergent_applied"].tolist() == [0, 1 << 24], r


def test_knob_unset_is_inert(world):
    p, ranks = world
    for r, got in enumerate(ranks):
        assert got["inert"].tolist() == [0, 0, 1], (p, r)


def test_torch_engine_span_carries_the_plan(world):
    p, ranks = world
    want = np.stack([_payloads(r)["f32_40008"] for r in range(p)]).sum(0)
    for got in ranks:
        assert str(got["engine_tag"]) == f"rotate@{_lag_of(p)}"
        assert got["engine_out"].tobytes() == want.tobytes()


def _subgroup_rank(rank: int, p: int, device) -> dict:
    """Pairs {0, 1} and {2, 3}, crossing pairs {0, 2} and {1, 3}; each
    rank's candidate accuses itself, so the pairs' first ranks hold
    different ones. A boundary over a pair adopts None; a boundary over
    the world adopts rank 0's; a call over a pair never plans."""
    import torch.distributed as dist
    from rabit_tpu_torch.parallel import collectives as C
    os.environ["RABIT_DISPATCH_TABLE"] = "none"
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    crossing = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    own, cross = pairs[rank // 2], crossing[rank % 2]
    x = torch.arange(4096, dtype=torch.int32) * (rank + 1)
    got, tags = {}, []
    try:
        os.environ["RABIT_SKEW_ADAPT"] = "1"
        os.environ["RABIT_SKEW_SYNC_ROUNDS"] = "1"   # a boundary a call
        ts.reset_monitor()
        ts.monitor().observe(_digest(p, rank))
        for name, g in (("own", own), ("cross", cross)):
            for method in ("ring", "tree", "auto"):
                got[f"{name}/{method}"] = C.allreduce(
                    x, g, SUM, method=method).numpy()
                tags.append(f"{name}/{method}={ts.last_applied()}")
        got["applied_sub"] = np.array(str(ts.monitor().applied()))
        got["world"] = C.allreduce(x, None, SUM, method="ring").numpy()
        tags.append(f"world={ts.last_applied()}")
        # no boundary now: the world's digest stays applied, and a pair
        # does not read it
        os.environ["RABIT_SKEW_SYNC_ROUNDS"] = "1000"
        got["cross_after"] = C.allreduce(x, cross, SUM,
                                         method="ring").numpy()
        tags.append(f"cross_after={ts.last_applied()}")
        got["rs"] = C.device_reduce_scatter(x, cross).numpy()
        tags.append(f"rs={ts.last_applied()}")
        got["applied_world"] = np.array(
            ts.laggard_of(ts.monitor().applied()))
        got["tags"] = np.array(tags)
    finally:
        for k in ("RABIT_SKEW_ADAPT", "RABIT_SKEW_SYNC_ROUNDS",
                  "RABIT_DISPATCH_TABLE"):
            os.environ.pop(k, None)
        ts.reset_monitor()
    return got


def test_subgroups_with_divergent_candidates_plan_nothing(tmp_path):
    """A boundary passed over a proper sub-group adopts no digest (each
    pair's first rank would broadcast its own candidate), and a call
    over a sub-group never plans, so the crossing pairs run one schedule
    on both members; a boundary over the world adopts rank 0's."""
    p = 4
    ranks = run_world(_subgroup_rank, p, "cpu", timeout_s=WORLD_TIMEOUT_S,
                      arrays=True, tmp=str(tmp_path))
    xs = [np.arange(4096, dtype=np.int32) * (r + 1) for r in range(p)]
    for r, got in enumerate(ranks):
        own = xs[r // 2 * 2] + xs[r // 2 * 2 + 1]
        cross = xs[r % 2] + xs[r % 2 + 2]
        for method in ("ring", "tree", "auto"):
            assert got[f"own/{method}"].tobytes() == own.tobytes(), r
            assert got[f"cross/{method}"].tobytes() == cross.tobytes(), r
        assert got["world"].tobytes() == sum(xs).tobytes(), r
        assert got["cross_after"].tobytes() == cross.tobytes(), r
        half = cross.size // 2
        mine = cross[:half] if r < 2 else cross[half:]
        assert got["rs"].tobytes() == mine.tobytes(), r
        assert str(got["applied_sub"]) == "None", r
        assert int(got["applied_world"]) == 0, r
        tags = dict(t.split("=", 1) for t in got["tags"].tolist())
        assert tags.pop("world").endswith("@0"), (r, tags)  # rank 0's
        assert set(tags.values()) == {"None"}, (r, tags)


def test_sync_point_refuses_a_cpu_tensor_on_nccl(clean, monkeypatch):
    """Over NCCL the agreement vector must travel on the card: a CPU
    payload raises instead of skipping the broadcast."""
    from rabit_tpu_torch.parallel import collectives as C
    monkeypatch.setattr(C.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(C.dist, "get_backend", lambda group=None: "nccl")
    ts.reset_monitor()
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        C._skew_sync_point(None, torch.device("cpu"))


def test_world_of_one_adopts_its_own_candidate(clean, tmp_path):
    """A group of one process: the boundary adopts the local candidate and
    broadcasts nothing."""
    import torch.distributed as dist
    from rabit_tpu_torch.parallel import collectives as C
    clean.setenv("RABIT_SKEW_ADAPT", "1")
    ts.reset_monitor()
    ts.monitor().observe(_digest(1, 0))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    calls = []
    clean.setattr(C.dist, "broadcast", lambda *a, **k: calls.append(a))
    try:
        x = torch.arange(8, dtype=torch.float32)
        assert torch.equal(C.allreduce(x, None, SUM), x)
        assert ts.monitor().applied() == ts.parse_digest(_digest(1, 0))
        assert calls == [] and ts.last_applied() is None
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- engines


def test_torch_engine_exports_the_knobs_and_undoes_them(clean):
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    e = TorchEngine()
    e.init(["rabit_device=cpu", "rabit_skew_adapt=1",
            "rabit_skew_poll_ms=150", "rabit_skew_sync_rounds=4",
            "rabit_skew_preagg_ms=0.5", "rabit_tracker_uri=127.0.0.1",
            "rabit_tracker_port=9"])
    try:
        assert os.environ["RABIT_SKEW_ADAPT"] == "1"
        assert ts.sync_rounds() == 4 and ts.poll_interval_s() == 0.15
        assert ts.preagg_ms_per_mib() == 0.5
        assert os.environ["RABIT_SKEW_TRACKER"] == "127.0.0.1:9"
    finally:
        e.shutdown()
    for k in ("RABIT_SKEW_ADAPT", "RABIT_SKEW_POLL_MS",
              "RABIT_SKEW_SYNC_ROUNDS", "RABIT_SKEW_TRACKER"):
        assert k not in os.environ, k
    with pytest.raises(ValueError, match="RABIT_SKEW_SYNC_ROUNDS"):
        TorchEngine().init(["rabit_device=cpu", "rabit_skew_sync_rounds=x"])
    assert "RABIT_SKEW_SYNC_ROUNDS" not in os.environ
    # an init that fails after the export undoes it too
    with pytest.raises(ValueError, match="rabit_reduce_method"):
        TorchEngine().init(["rabit_device=cpu", "rabit_skew_adapt=1",
                            "rabit_skew_sync_rounds=4",
                            "rabit_reduce_method=butterfly"])
    for k in ("RABIT_SKEW_ADAPT", "RABIT_SKEW_SYNC_ROUNDS"):
        assert k not in os.environ, k


@pytest.mark.parametrize("how", ["arg", "env"])
def test_engines_refuse_the_hot_standby(clean, how):
    """The poller's failover to a hot standby is not ported: the knob
    raises at init in both engines rather than be ignored."""
    import rabit_tpu_torch
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    args = ["rabit_device=cpu"]
    if how == "arg":
        args.append("rabit_tracker_standby=127.0.0.1:9")
    else:
        clean.setenv("RABIT_TRACKER_STANDBY", "127.0.0.1:9")
    with pytest.raises(NotImplementedError, match="not ported"):
        TorchEngine().init(args)
    rabit_tpu_torch.finalize()
    with pytest.raises(NotImplementedError, match="not ported"):
        rabit_tpu_torch.init(args[1:], engine="robust")
    assert rabit_tpu_torch._engine is None


def test_robust_data_plane_adapts_and_reagrees_after_a_reformation(clean):
    """``engine="robust_torch"`` over gloo at world 2: the engine's
    ``rabit_skew_*`` arguments reach the data plane, every round runs the
    rotated ring around the forced digest's laggard with an exact sum, a
    scripted data-plane failure re-forms the world (which re-arms the
    boundary on every rank), and the spans carry the plan
    (``tests/workers/torch_skew_dataplane_worker.py``)."""
    import sys
    from rabit_tpu_torch.engine import _native_build
    from rabit_tpu_torch.tracker.launch import launch
    _native_build.build()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, os.path.join(root, "tests", "workers",
                                        "torch_skew_dataplane_worker.py"),
           "rabit_dataplane=torch", "rabit_dataplane_minbytes=0",
           "rabit_device=cpu", "rabit_telemetry=1", "rabit_skew_adapt=1",
           "rabit_skew_sync_rounds=2", "rabit_skew_preagg_ms=0"]
    stats = {}
    assert launch(2, cmd, timeout=120, quiet=True, stats=stats, env={
        "RABIT_SKEW_DIGEST": json.dumps(_digest(2, 1)),
        "RABIT_DATAPLANE_FAIL_AT": "2"}) == 0
    assert stats["total_attempts"] == 0 and stats["epoch"] >= 2

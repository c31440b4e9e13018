"""The port's elastic membership module (``rabit_tpu_torch/tracker/
membership.py``) against ``rabit_tpu/tracker/membership.py``: the tracker-
side ``MembershipView`` through the same scripted transitions (its
expected sets, return values, counters and ``world`` docs equal at every
step), the dense slots, the env knobs, the worker-side identity and
monitor, and the per-module ``epoch_reset`` hooks an elastic resize runs
(membership, topology, dispatch, skew), with the checkpoint store's
resize protection and peer-shard adoption; then ``NativeEngine`` and
``TorchEngine`` ``epoch_reset`` on a store. These are the cases of
``tests/test_membership.py``, parametrised where they repeat each other."""

import os

import pytest

from rabit_tpu.engine.ckpt_store import CheckpointStore as JaxStore
from rabit_tpu.telemetry import skew as jax_skew
from rabit_tpu.tracker import membership as jax_membership
from rabit_tpu_torch.engine import _native_build
from rabit_tpu_torch.engine.ckpt_store import CheckpointStore
from rabit_tpu_torch.telemetry import skew
from rabit_tpu_torch.tracker import membership


def _view_trace(mod, script):
    """Run ``script`` (a list of (method, arg) steps) on a fresh view of
    ``mod``: every step's return value and the view's state after it."""
    v = mod.MembershipView(4)
    out = []
    for step, arg in script:
        if step == "doc":
            got = v.doc(arg)
        elif step == "expected":
            got = sorted(v.expected())
        elif step == "world":
            got = v.world()
        elif step == "formed":
            got = sorted(v.formed(arg))
        else:
            got = getattr(v, step)(arg)
        out.append((step, arg, got, sorted(v.live), sorted(v.evicted),
                    sorted(v.joining), v.generation, v.evictions,
                    v.admissions))
    return out


SCRIPTS = {
    "before_formation": [("expected", None), ("world", None),
                         ("doc", 0)],
    "evict_before_formation": [("evict", 3), ("expected", None),
                               ("evict", 3), ("doc", 0),
                               ("formed", {0, 1, 2}), ("doc", 1)],
    "evict_then_readmit": [("formed", range(4)), ("doc", 1),
                           ("evict", 1), ("expected", None), ("doc", 1),
                           ("formed", {0, 2, 3}), ("world", None),
                           ("doc", 2), ("park", 0), ("park", 1),
                           ("expected", None), ("doc", 2),
                           ("formed", {0, 1, 2, 3}), ("world", None),
                           ("doc", 3)],
    "holey_slots": [("formed", {0, 2, 3}), ("doc", 2), ("evict", 0),
                    ("doc", 2), ("formed", {2, 3}), ("doc", 3),
                    ("park", 0), ("evict", 0), ("doc", 3)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_view_matches_the_jax_view_step_by_step(name):
    want = _view_trace(jax_membership, SCRIPTS[name])
    got = _view_trace(membership, SCRIPTS[name])
    assert got == want


def test_view_lifecycle_evict_then_readmit():
    v = membership.MembershipView(4)
    assert v.expected() == {0, 1, 2, 3} and v.world() == 4
    assert v.formed(range(4)) == set(), "nobody was parked initially"
    gen = v.generation
    assert v.evict(1) and v.expected() == {0, 2, 3}
    assert v.generation > gen
    assert not v.evict(1), "double-evict must be a no-op"
    assert v.formed({0, 2, 3}) == set() and v.world() == 3
    assert not v.park(0), "parking a live member is plain recovery"
    assert v.park(1) and v.expected() == {0, 1, 2, 3}
    assert v.formed({0, 1, 2, 3}) == {1}
    assert v.world() == 4 and v.admissions == 1 and v.evictions == 1
    assert v.evicted == set() and v.joining == set()
    doc = v.doc(epoch=3)
    assert doc["slots"] == {str(r): r for r in range(4)}
    assert doc["elastic"] is True and doc["epoch"] == 3


@pytest.mark.parametrize("members", [range(4), {0, 2, 5}, (), {3}, {7, 1}])
def test_dense_slots_match(members):
    assert membership.dense_slots(members) == \
        jax_membership.dense_slots(members)


def test_constants_match():
    for name in ("JOIN_GRACE_MS_DEFAULT", "EVICT_POLL_MISSES",
                 "_ELASTIC_ENV", "_GRACE_ENV", "_ON"):
        assert getattr(membership, name) == getattr(jax_membership, name)
    assert membership.MembershipMonitor.RECONNECT_MISSES == \
        jax_membership.MembershipMonitor.RECONNECT_MISSES


@pytest.mark.parametrize("value", [None, "1", "true", "YES", " on ", "off",
                                   "0", ""])
def test_elastic_enabled_parses_env_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("RABIT_ELASTIC", raising=False)
    else:
        monkeypatch.setenv("RABIT_ELASTIC", value)
    assert membership.elastic_enabled() == jax_membership.elastic_enabled()


@pytest.mark.parametrize("value", [None, "", "2500", "0", "-4", "soon"])
def test_join_grace_ms_parses_env_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("RABIT_JOIN_GRACE_MS", raising=False)
    else:
        monkeypatch.setenv("RABIT_JOIN_GRACE_MS", value)
    if value == "soon":
        with pytest.raises(ValueError):
            membership.join_grace_ms()
        with pytest.raises(ValueError):
            jax_membership.join_grace_ms()
    else:
        assert membership.join_grace_ms() == jax_membership.join_grace_ms()


def test_identity_and_resume_without_a_server(monkeypatch):
    """``note_identity`` keeps the formed identity; ``present_resume``
    says False with no tracker to talk to (no address), and when the
    tracker does not know the identity (a tracker without a journal,
    whose world has no rank 2)."""
    monkeypatch.delenv("RABIT_TRACKER_URI", raising=False)
    monkeypatch.delenv("RABIT_TRACKER_PORT", raising=False)
    membership.note_identity("7", 2, 3)
    assert membership.identity() == ("7", 2, 3)
    assert membership.present_resume() is False
    from rabit_tpu_torch.tracker.tracker import Tracker
    tr = Tracker(2).start()
    try:
        assert membership.present_resume(tr.host, tr.port) is False
        doc = membership.fetch_world(tr.host, tr.port)
        assert doc["elastic"] is False and doc["world"] == 2
    finally:
        tr.stop()
    assert membership.fetch_world("127.0.0.1", 1, timeout=0.2) is None


def test_monitor_sees_an_eviction_after_its_formed_baseline():
    from rabit_tpu_torch.tracker.tracker import Tracker
    tr = Tracker(3, elastic=True).start()
    try:
        mon = membership.MembershipMonitor(tr.host, tr.port, "0")
        mon.note_formed()
        assert not mon.reformation_due()
        assert tr.evict_rank(2, "test")
        assert not mon.reformation_due(), "reads touch the cache only"
        mon.refresh()
        assert mon.reformation_due()
        assert mon.current()["evicted"] == [2]
        mon.note_formed()
        assert not mon.reformation_due()
    finally:
        tr.stop()


def test_membership_epoch_reset_replaces_monitor():
    before = membership.monitor()
    membership.epoch_reset(3)
    after = membership.monitor()
    assert after is not before
    assert not after.reformation_due()


# ------------------------------------------------------- fleet election


def _served(mod, offsets, laggard, evict):
    e = mod.FleetElection(alpha=1.0, hysteresis_ms=0.0)
    first = e.fold({"offsets_ms": offsets, "laggard": laggard})
    e.evict(evict)
    return first, e.fold(None)


@pytest.mark.parametrize("offsets,laggard,evict", [
    ({0: 0.0, 1: 5.0, 2: 40.0}, 2, 2),     # the served laggard: new epoch
    ({0: 0.0, 1: 5.0, 2: 40.0}, 2, 0),     # a bystander: same epoch
    ({0: 10.0}, 0, 0),                     # the last rank: no laggard
])
def test_election_evict_matches_jax(offsets, laggard, evict):
    got = _served(skew, offsets, laggard, evict)
    assert got == _served(jax_skew, offsets, laggard, evict)
    assert str(evict) not in got[1]["offsets_ms"]


@pytest.mark.parametrize("world", [2, 3, 4, 7])
def test_rotation_order_matches_jax(world):
    for lag in range(world):
        order = skew.rotation_order(world, lag)
        assert list(order) == list(jax_skew.rotation_order(world, lag))
        assert order[-1] == lag
    with pytest.raises(ValueError):
        skew.rotation_order(world, world)


# --------------------------------------------------- ckpt resize safety


def _protect_then_prune(cls, root):
    st = cls(str(root), rank=0, keep=2)
    seen = [st.protect_current()]
    for v in (1, 2):
        st.save(v, f"g{v}".encode())
    seen.append(st.protect_current())
    st.save(3, b"g3")
    seen.append(st.protected_version)
    st.save(4, b"g4")
    st.save(5, b"g5")
    seen.append(st.versions())
    pinned = cls(str(root / "pin"), rank=0, keep=1)
    pinned.save(1, b"old-world")
    seen.append(pinned.protect_current())
    open(pinned.path_for(2), "wb").write(b"")   # a newer name, no save()
    seen += [pinned.prune(), pinned.versions()]
    return seen


def _adopt(cls, root):
    donor = cls(str(root), rank=0, keep=2)
    donor.save(3, b"global-v3", b"local-r0")
    joiner = cls(str(root), rank=5, keep=2)
    return [joiner.adopt_latest_from_peers(), joiner.load(3),
            joiner.protected_version, joiner.adopt_latest_from_peers(),
            donor.adopt_latest_from_peers()]


@pytest.mark.parametrize("case", [_protect_then_prune, _adopt])
def test_store_resize_protection_matches_jax(tmp_path, case):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = case(JaxStore, tmp_path / "jax")
    got = case(CheckpointStore, tmp_path / "port")
    assert got == want
    if case is _protect_then_prune:
        assert got[:4] == [None, 2, None, [4, 5]]
        assert 1 in got[-1], "pinned version must survive prune"
    else:
        assert got[0] == 3 and got[1] == (b"global-v3", b"local-r0")


# --------------------------------------------------- epoch_reset hooks


@pytest.mark.parametrize("world,kept", [(3, False), (4, True)])
def test_topology_epoch_reset_as_jax(monkeypatch, world, kept):
    from rabit_tpu.parallel import topology as jax_topology
    from rabit_tpu_torch.parallel import topology
    for mod in (topology, jax_topology):
        monkeypatch.setenv("RABIT_HIER_GROUP", "0,1|2,3")
        mod.epoch_reset(world)
        assert ("RABIT_HIER_GROUP" in os.environ) == kept
        if kept:
            assert os.environ["RABIT_HIER_GROUP"] == "0,1|2,3"


def test_skew_and_dispatch_epoch_reset_drop_applied_state():
    from rabit_tpu_torch.parallel import dispatch
    skew.note_applied("rotate@2")
    skew.monitor().observe({"epoch": 1, "offsets_ms": {"0": 0.0},
                            "laggard": 0})
    skew.epoch_reset(3)
    assert skew.last_applied() is None
    assert skew.monitor().applied() is None
    dispatch.epoch_reset(3)   # must not raise; the cache is world-keyed


@pytest.fixture(scope="module")
def native_core():
    _native_build.build()


def _peer_store(root):
    """A sibling's durable shard at version 2: a re-admitted rank's empty
    store adopts it at its epoch reset."""
    CheckpointStore(str(root), rank=1, keep=2).save(2, b"peer-v2")


@pytest.mark.parametrize("engine", ["robust", "torch"])
def test_engine_epoch_reset_protects_and_adopts(tmp_path, native_core,
                                                engine):
    """Both engines' epoch hooks at world 1: the newest checkpoint is
    pinned, the peer's newer shard adopted, the monitor replaced, and
    the transition counted, spanned, noted and emitted."""
    import rabit_tpu_torch
    from rabit_tpu_torch import telemetry
    from rabit_tpu_torch.telemetry import events, flight
    _peer_store(tmp_path)
    rabit_tpu_torch.finalize()
    args = [f"rabit_ckpt_dir={tmp_path}", "rabit_telemetry=1",
            "rabit_events=1", f"rabit_flight_dir={tmp_path / 'flight'}"]
    if engine == "torch":
        args.append("rabit_device=cpu")
    rabit_tpu_torch.init(args, engine=engine)
    try:
        eng = rabit_tpu_torch._engine
        assert eng.load_checkpoint()[0] in (0, 2)
        before = membership.monitor()
        eng.epoch_reset(1)
        assert membership.monitor() is not before
        assert eng._store.versions() == [2]
        assert eng._store.protected_version == 2
        snap = telemetry.snapshot()
        assert any(c["name"] == "membership.epoch_reset"
                   for c in snap["counters"])
        spans = [s for s in snap["spans"]
                 if s["name"] == "membership.transition"]
        assert spans and spans[-1]["op"] == "resize"
        assert spans[-1]["attrs"]["world"] == 1
        kinds = [e["kind"] for e in events.snapshot()["records"]]
        assert "membership.epoch_reset" in kinds
        assert "member_resize" in [n["kind"] for n in
                                   flight.recent_events()]
    finally:
        rabit_tpu_torch.finalize()
        rabit_tpu_torch.init(["rabit_telemetry=0", "rabit_events=0"],
                             engine="robust")
        rabit_tpu_torch.finalize()


def _resize_outcomes(lib, engine, args):
    """What ``resize`` does for each command under ``engine`` at world 1
    with no tracker: the world it leaves, or the exception's type."""
    out = []
    lib.init(args, engine=engine)
    try:
        for cmd in ("recover", "join", "grow"):
            try:
                lib.resize(cmd)
                out.append(lib.get_world_size())
            except (NotImplementedError, ValueError) as e:
                out.append(type(e).__name__)
    finally:
        lib.finalize()
    return out


@pytest.mark.parametrize("port,jax", [("robust", "native"),
                                      ("empty", "empty"),
                                      ("torch", "empty")])
def test_resize_at_world_one_as_jax(native_core, port, jax):
    """``resize`` takes ``recover`` or ``join`` only; a native engine with
    no tracker has nothing to rewire (world 1 stays), and an engine
    without a tracker-registered link plane raises, as JAX's do."""
    import rabit_tpu
    import rabit_tpu_torch
    rabit_tpu_torch.finalize()
    want = _resize_outcomes(rabit_tpu, jax, [])
    got = _resize_outcomes(rabit_tpu_torch, port, ["rabit_device=cpu"])
    assert got == want
    assert got == ([1, 1, "ValueError"] if port == "robust"
                   else ["NotImplementedError"] * 3)

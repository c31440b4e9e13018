"""Elastic membership on the port's tracker and launcher
(``rabit_tpu_torch/tracker``), the cases of ``tests/test_elastic.py``:
an eviction unblocks survivors blocked in registration, a new task id
adopts the lowest evicted stable rank, a tracker with elastic off is
unchanged, re-admissions are exempt from the launcher's budget while the
budget without elastic still holds; then one scripted sequence through
BOTH trackers (form 4, evict 1, the survivors re-register, a ``join``,
the world back to 4) whose assignment blobs and ``world`` docs are equal
at every step. Beside them, what the port's single-job tracker adds
around the same state: a parked joiner bounced after its grace, the
poll loop's eviction of a silent endpoint, the elastic gauges under the
JAX names, and the store of an epoch kept while an evicted member may
still hold it."""

import json
import socket
import struct
import sys
import threading
import time

import pytest

from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch.tracker import launch as port_launch
from rabit_tpu_torch.tracker.tracker import MAGIC, Tracker


# ------------------------------------------------------- wire helpers


def _send_u32(c, v):
    c.sendall(struct.pack("<I", v))


def _send_str(c, s):
    b = s.encode()
    _send_u32(c, len(b))
    c.sendall(b)


def _recv_exact(c, n):
    out = b""
    while len(out) < n:
        chunk = c.recv(n - len(out))
        if not chunk:
            raise ConnectionError("tracker closed the connection")
        out += chunk
    return out


def _recv_u32(c):
    return struct.unpack("<I", _recv_exact(c, 4))[0]


def _recv_str(c):
    return _recv_exact(c, _recv_u32(c)).decode()


def register(tr, task, cmd="start", flags=0):
    c = socket.create_connection((tr.host, tr.port), timeout=10)
    c.settimeout(30)
    _send_u32(c, MAGIC)
    _send_str(c, cmd)
    _send_str(c, task)
    _send_u32(c, 0)
    _send_str(c, "127.0.0.1")
    _send_u32(c, 9200 + (int(task[-1]) if task[-1].isdigit() else 99))
    _send_u32(c, flags)
    _send_str(c, f"tok-{task}")
    return c


def register_in_order(tr, tasks, cmd="start", flags=0):
    """Register ``tasks`` one at a time, so that a new task's stable rank
    is its place in the list (ranks go by order of registration)."""
    conns = []
    for t in tasks:
        known = len(tr._ranks)
        conns.append(register(tr, t, cmd, flags))
        if t not in tr._ranks:
            _wait(lambda: len(tr._ranks) > known)
    return conns


def read_blob(c):
    """One assignment as its fields: (rank, world, epoch, coord_host,
    coord_port, single_host, parent, tree, ring_prev, ring_next,
    connect list, naccept)."""
    head = [_recv_u32(c) for _ in range(3)]
    coord = [_recv_str(c), _recv_u32(c)]
    single, parent = _recv_u32(c), _recv_u32(c)
    tree = [_recv_u32(c) for _ in range(_recv_u32(c))]
    ring = [_recv_u32(c), _recv_u32(c)]
    connect = [(_recv_u32(c), _recv_str(c), _recv_u32(c), _recv_str(c))
               for _ in range(_recv_u32(c))]
    return (*head, *coord, single, parent, tree, *ring, connect,
            _recv_u32(c))


def read_assignment(c):
    rank, world, epoch = read_blob(c)[:3]
    _send_u32(c, 1)   # ready ack
    c.close()
    return rank, world, epoch


def command(tr, cmd, payload=None, task="test"):
    c = socket.create_connection((tr.host, tr.port), timeout=10)
    _send_u32(c, MAGIC)
    _send_str(c, cmd)
    _send_str(c, task)
    _send_u32(c, 0)
    if payload is not None:
        _send_str(c, payload)
        out = _recv_u32(c)
    else:
        out = json.loads(_recv_str(c))
    c.close()
    return out


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


# -------------------------------------------------- tracker protocol


def test_evict_unblocks_survivors_blocked_in_registration():
    """Survivors registering into a world with a dead member do not wait
    out a timeout on it: the eviction removes it from the expected set
    and the pending batch forms at once at N-1."""
    tracker = Tracker(3, elastic=True).start()
    try:
        conns = register_in_order(tracker, ["0", "1"])
        _wait(lambda: len(tracker._pending) == 2)
        ok = []
        evictor = threading.Thread(target=lambda: ok.append(command(
            tracker, "evict", json.dumps({"rank": 2, "reason": "dead"}))))
        evictor.start()
        got = sorted(read_assignment(c) for c in conns)
        evictor.join(timeout=10)
        assert ok == [1], ok
        assert got == [(0, 2, 1), (1, 2, 1)], got
        doc = command(tracker, "world")
        assert doc["live"] == [0, 1] and doc["evicted"] == [2], doc
        # out of range, already out: refused
        for rank in (2, 7, -1):
            assert command(tracker, "evict", json.dumps(
                {"rank": rank, "reason": "again"})) == 0
        assert command(tracker, "evict", "not json") == 0
    finally:
        tracker.stop()


def test_new_task_id_adopts_lowest_evicted_stable_rank():
    """Replacement hardware arrives under a NEW task id: it adopts the
    vacated stable rank, not a bounce for exceeding the target world."""
    tracker = Tracker(2, elastic=True).start()
    try:
        conns = register_in_order(tracker, ["0", "1"])
        for c in conns:
            read_assignment(c)
        assert command(tracker, "evict",
                       json.dumps({"rank": 1, "reason": "preempted"})) == 1
        assert read_assignment(register(tracker, "0", cmd="recover")) \
            == (0, 1, 2)
        joiner = register(tracker, "replacement-7", cmd="join")
        _wait(lambda: command(tracker, "world").get("joining") == [1])
        survivor = register(tracker, "0", cmd="recover")
        a = read_assignment(survivor)
        b = read_assignment(joiner)
        assert a == (0, 2, 3) and b == (1, 2, 3), (a, b)
        doc = command(tracker, "world")
        assert doc["evicted"] == [] and doc["world"] == 2, doc
        assert tracker._ranks["replacement-7"] == 1
    finally:
        tracker.stop()


def test_inelastic_tracker_is_unchanged(monkeypatch):
    """With ``rabit_elastic`` unset nothing of the fixed-world tracker
    moves: the membership doc is static, the evict command is refused,
    ``join`` is a plain registration, and the world still forms only
    when every rank shows."""
    monkeypatch.delenv("RABIT_ELASTIC", raising=False)
    tracker = Tracker(2).start()
    try:
        assert not tracker.elastic
        static = {"epoch": 0, "world": 2, "target": 2, "live": [0, 1],
                  "evicted": [], "joining": [], "generation": 0,
                  "elastic": False}
        assert command(tracker, "world") == static
        assert command(tracker, "evict",
                       json.dumps({"rank": 1, "reason": "nope"})) == 0
        assert tracker.membership_doc() == static
        conns = register_in_order(tracker, ["0"]) + \
            register_in_order(tracker, ["1"], "join")
        got = sorted(read_assignment(c) for c in conns)
        assert got == [(0, 2, 1), (1, 2, 1)], got
        assert command(tracker, "world") == dict(static, epoch=1)
    finally:
        tracker.stop()
    monkeypatch.setenv("RABIT_ELASTIC", "1")
    on, off = Tracker(2), Tracker(2, elastic=False)
    try:
        assert on.elastic and off.elastic is False
    finally:
        on.stop()
        off.stop()


# ----------------------------------------------------- launcher budget


_FLAKY = ("import os,sys;"
          "sys.exit(1 if int(os.environ.get('RABIT_NUM_TRIAL','0'))<3 "
          "else 0)")
_ENV_PROBE = ("import os,sys;"
              "sys.exit(0 if os.environ.get('RABIT_ELASTIC') == '1' "
              "else 5)")


def test_elastic_readmissions_are_budget_exempt(monkeypatch):
    """A rank that dies and is re-admitted is the mechanism WORKING:
    three deaths do not trip a per-rank budget of one."""
    monkeypatch.delenv("RABIT_ELASTIC", raising=False)
    stats = {}
    rc = port_launch.launch(1, [sys.executable, "-c", _FLAKY],
                            max_attempts=1, timeout=60, quiet=True,
                            stats=stats, elastic=True)
    assert rc == 0
    assert stats["readmissions"] == 3 and stats["total_attempts"] == 3
    assert stats["membership"]["elastic"] is True


@pytest.mark.parametrize("how", ["arg", "cmd", "env"])
def test_elastic_reaches_the_workers(monkeypatch, how):
    """``elastic=True``, ``rabit_elastic=1`` in the command and
    ``RABIT_ELASTIC=1`` each turn it on and export it to the workers."""
    monkeypatch.delenv("RABIT_ELASTIC", raising=False)
    cmd = [sys.executable, "-c", _ENV_PROBE]
    if how == "cmd":
        cmd.append("rabit_elastic=1")
    if how == "env":
        monkeypatch.setenv("RABIT_ELASTIC", "1")
    stats = {}
    assert port_launch.launch(1, cmd, max_attempts=0, timeout=60,
                              quiet=True, stats=stats,
                              elastic=True if how == "arg" else None) == 0
    assert stats["membership"]["elastic"] is True


@pytest.mark.parametrize("given,want", [(None, "0"), ("9300", "9300")])
def test_launcher_gives_an_ephemeral_link_port_unless_one_is_set(
        monkeypatch, given, want):
    """The workers' native cores listen on an ephemeral port
    (``RABIT_SLAVE_PORT=0``) unless the environment names a port."""
    if given is None:
        monkeypatch.delenv("RABIT_SLAVE_PORT", raising=False)
    else:
        monkeypatch.setenv("RABIT_SLAVE_PORT", given)
    probe = ("import os,sys;sys.exit(0 if os.environ.get("
             f"'RABIT_SLAVE_PORT') == {want!r} else 5)")
    assert port_launch.launch(1, [sys.executable, "-c", probe],
                              max_attempts=0, timeout=60, quiet=True) == 0


def test_inelastic_budget_still_enforced(monkeypatch):
    monkeypatch.delenv("RABIT_ELASTIC", raising=False)
    with pytest.raises(RuntimeError, match="per-rank"):
        port_launch.launch(1, [sys.executable, "-c", _FLAKY],
                           max_attempts=1, timeout=60, quiet=True,
                           elastic=False)


def test_launcher_cli_elastic_flag(capfd, monkeypatch):
    monkeypatch.delenv("RABIT_ELASTIC", raising=False)
    assert port_launch.main(["-n", "1", "--timeout", "60", "--elastic",
                             "--max-attempts", "0", "--", sys.executable,
                             "-c", _FLAKY]) == 0
    assert "re-admit attempt 3" in capfd.readouterr().err


# ------------------------------------- both trackers through one script


def _script(tr, elastic_doc=True):
    """Form 4, evict stable rank 1, the survivors re-register, rank 1
    joins, the world is back at 4. Returns every blob (rank, world,
    epoch, tree, ring, connect and accept lists by slot) and every
    ``world`` doc, in order."""
    seen = []
    conns = register_in_order(tr, [f"t{i}" for i in range(4)])
    blobs = [read_blob(c) for c in conns]
    for c in conns:
        _send_u32(c, 1)
        c.close()
    seen += [("form", blobs), ("doc", command(tr, "world"))]
    seen.append(("evict", command(tr, "evict", json.dumps(
        {"rank": 1, "reason": "script"}))))
    seen.append(("doc", command(tr, "world")))
    conns = [register(tr, f"t{i}", "recover") for i in (0, 2, 3)]
    blobs = [read_blob(c) for c in conns]
    for c in conns:
        _send_u32(c, 1)
        c.close()
    seen += [("shrink", blobs), ("doc", command(tr, "world"))]
    joiner = register(tr, "t1", "join")
    _wait(lambda: command(tr, "world").get("joining") == [1])
    seen.append(("doc", command(tr, "world")))
    conns = [register(tr, f"t{i}", "recover") for i in (0, 2, 3)]
    blobs = [read_blob(c) for c in [joiner] + conns]
    for c in [joiner] + conns:
        _send_u32(c, 1)
        c.close()
    seen += [("grow", blobs), ("doc", command(tr, "world"))]
    return seen


def test_four_three_four_blobs_and_docs_match_the_jax_tracker():
    jax_tr = JaxTracker(4, elastic=True).start()
    port_tr = Tracker(4, elastic=True).start()
    try:
        want = _script(jax_tr)
        got = _script(port_tr)
    finally:
        jax_tr.stop()
        port_tr.stop()
    assert got == want
    # the shrunk world's slots: stable 0, 2, 3 -> 0, 1, 2, a ring of 3
    shrink = dict(got)["shrink"]
    assert [b[:3] for b in shrink] == [(0, 3, 2), (1, 3, 2), (2, 3, 2)]
    assert got[-1][1]["world"] == 4 and got[-1][1]["epoch"] == 3
    assert port_tr._member.evictions == 1 and \
        port_tr._member.admissions == 1


# ------------------------------------- what the port's tracker adds


def test_parked_joiner_is_bounced_after_its_grace(monkeypatch):
    monkeypatch.setenv("RABIT_JOIN_GRACE_MS", "300")
    tracker = Tracker(2, elastic=True).start()
    try:
        conns = register_in_order(tracker, ["0", "1"])
        for c in conns:
            read_assignment(c)
        assert tracker.evict_rank(1, "test")
        assert read_assignment(register(tracker, "0", "recover")) \
            == (0, 1, 2)
        joiner = register(tracker, "1", "join")
        t0 = time.monotonic()
        assert joiner.recv(1) == b""   # closed without an assignment
        assert 0.2 < time.monotonic() - t0 < 10
        assert tracker._pending == {}
        assert command(tracker, "world")["joining"] == [1]
    finally:
        tracker.stop()


def test_poll_loop_evicts_a_silent_endpoint(monkeypatch):
    """An endpoint that answered before and then stays silent for
    ``EVICT_POLL_MISSES`` sweeps is evicted; the survivor's registration
    then forms alone."""
    from rabit_tpu_torch.telemetry import live
    monkeypatch.setenv("RABIT_METRICS_POLL_MS", "50")
    servers = [live.MetricsServer(
        port=0, summary_fn=lambda r=r: {"rank": r, "counters": []},
        identity={"rank": r}).start() for r in range(2)]
    tracker = Tracker(2, elastic=True, metrics_port=0).start()
    try:
        conns = register_in_order(tracker, ["0", "1"])
        for c in conns:
            read_assignment(c)
        for r, srv in enumerate(servers):
            assert command(tracker, "endpoint", json.dumps(
                {"host": "127.0.0.1", "port": srv.port, "rank": r}),
                task=str(r)) == 1
        _wait(lambda: len(tracker._metrics) == 2)
        servers[1].stop()
        _wait(lambda: command(tracker, "world")["evicted"] == [1])
        assert read_assignment(register(tracker, "0", "recover")) \
            == (0, 1, 2)
        assert tracker._endpoint_misses["1"] >= 3
    finally:
        tracker.stop()
        servers[0].stop()


def test_elastic_gauges_use_the_jax_names():
    jax_tr = JaxTracker(3, elastic=True)
    port_tr = Tracker(3, elastic=True)
    off = Tracker(3, elastic=False)
    names = ("rabit_world_size", "rabit_member_evictions_total",
             "rabit_member_admissions_total")
    try:
        for tr in (jax_tr, port_tr):
            tr._member.formed({0, 1, 2})
            tr._member.evict(2)
            tr._member.formed({0, 1})
            tr._member.park(2)
            tr._member.formed({0, 1, 2})
            tr._member.evict(0)
        pick = lambda tr: [g for g in tr._live_gauges()  # noqa: E731
                           if g[0] in names]
        assert pick(port_tr) == pick(jax_tr)
        assert [g[3] for g in pick(port_tr)] == [[({}, 2)], [({}, 2)],
                                                 [({}, 1)]]
        assert pick(off) == []
    finally:
        for tr in (jax_tr, port_tr, off):
            tr.stop()


def test_store_kept_while_an_evicted_member_may_hold_it():
    """The store of the epoch an evicted process last formed stays until
    that member acks a newer epoch: its process may live on with a client
    of it (the in-process ``resize("join")``)."""
    tracker = Tracker(3, elastic=True, ready_timeout=10).start()

    def form(tasks, cmd):
        conns = register_in_order(tracker, tasks, cmd, flags=1)
        blobs = [read_blob(c) for c in conns]
        for c in conns:
            _send_u32(c, 1)
            c.close()
        return blobs

    try:
        form(["0", "1", "2"], "start")
        _wait(lambda: tracker.store_count() == 1)
        assert tracker.evict_rank(2, "test")
        form(["0", "1"], "recover")
        time.sleep(0.3)
        assert tracker.store_count() == 2     # epoch 1 kept for rank 2
        joiner = register(tracker, "2", "join", flags=1)
        _wait(lambda: command(tracker, "world")["joining"] == [2])
        blobs = form(["0", "1"], "recover")
        blobs.append(read_blob(joiner))
        _send_u32(joiner, 1)
        joiner.close()
        assert {b[2] for b in blobs} == {3}
        assert len({b[4] for b in blobs}) == 1   # one store, epoch 3
        _wait(lambda: tracker.store_count() == 1)
    finally:
        tracker.stop()


def _post_cards(cards):
    """Every member of a world posts its card to one store at once (the
    formation's check); each member's error, or None."""
    import torch.distributed as dist
    from rabit_tpu_torch.engine.dataplane import check_distinct_cards
    store = dist.HashStore()
    errors = [None] * len(cards)

    def member(r):
        try:
            check_distinct_cards(store, r, len(cards), cards[r])
        except RuntimeError as e:
            errors[r] = str(e)

    threads = [threading.Thread(target=member, args=(r,))
               for r in range(len(cards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return errors


def test_a_relaunch_into_a_shrunk_world_keeps_its_own_card():
    """Four processes on four cards; stable ranks 0 and 2 are evicted;
    the launcher relaunches task 2, whose first formation is in the
    shrunk world {1, 2, 3} as slot 1. Its card comes from its task index
    (card 2), not from the slot (card 1, which task 1 holds), and the
    epoch's members post distinct cards; a slot-picked card would fail
    the formation's check with both ranks named."""
    from rabit_tpu_torch.engine.dataplane import card_index
    cards = 4   # the device count of a four-card host
    tracker = Tracker(4, elastic=True).start()

    def form(conns):
        blobs = [read_blob(c) for c in conns]
        for c in conns:
            _send_u32(c, 1)
            c.close()
        return blobs

    try:
        first = form(register_in_order(tracker, ["0", "1", "2", "3"]))
        card = {t: card_index(b[0], cards, t)
                for t, b in zip("0123", first)}
        assert card == {"0": 0, "1": 1, "2": 2, "3": 3}
        for r in (0, 2):
            assert command(tracker, "evict", json.dumps(
                {"rank": r, "reason": "dead"})) == 1
        shrunk = form([register(tracker, t, "recover") for t in "13"])
        assert [b[:2] for b in shrunk] == [(0, 2), (1, 2)]
        relaunch = register(tracker, "2")   # a fresh process: parked
        _wait(lambda: command(tracker, "world").get("joining") == [2])
        conns = [register(tracker, t, "recover") for t in "13"]
        grown = dict(zip("213", form([relaunch] + conns)))
        assert {t: b[:2] for t, b in grown.items()} == \
            {"1": (0, 3), "2": (1, 3), "3": (2, 3)}
        card["2"] = card_index(grown["2"][0], cards, "2")
        assert card["2"] == 2
        by_slot = {grown[t][0]: f"host/{card[t]}" for t in "123"}
        assert _post_cards([by_slot[s] for s in range(3)]) == [None] * 3
        # the slot's card, as the process would pick without a task index
        assert card_index(grown["2"][0], cards, "replacement") == 1
        by_slot[grown["2"][0]] = "host/1"
        errors = _post_cards([by_slot[s] for s in range(3)])
        assert all(e and "ranks 0 and 1" in e and "host/1" in e
                   for e in errors), errors
    finally:
        tracker.stop()

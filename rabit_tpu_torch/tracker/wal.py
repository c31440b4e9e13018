"""Append-only write-ahead log of the tracker's control plane: the
port's copy of ``rabit_tpu/tracker/wal.py``, whole.

A tracker holds the job's topology, skew elections and elastic
membership in memory, so without a journal its death kills the job even
though every worker and the whole data plane are healthy ("Highly
Available Data Parallel ML training on Mesh Networks",
arXiv:2011.03605, makes the case that the control plane must survive
component loss independently of the data plane). Every control-plane
transition the tracker commits (rank assignment, epoch advance,
membership decision, topology doc, skew verdict, endpoint announce,
shutdown) is journaled here BEFORE it takes effect, and a restarted
tracker replays the journal to re-adopt the live world
(``tracker.py``, ``resume=True``) without restarting any worker.

File format (all integers little-endian)::

    8s   file magic "RBTWAL01"        (version-prefixed: bump on change)
    then zero or more records, each:
      I  len(payload)
      I  crc32(payload)
      ...payload: canonical JSON {"seq": n, "kind": str, "data": {...}}

``seq`` starts at 1 and increments by exactly 1 per record: replay is
deterministic and any reordering or splice is detected as corruption.
The format, the canonical JSON and the record kinds are the JAX
package's, so a journal written by either package's tracker replays in
the other's, and the same transitions give the same bytes.

Snapshot compaction: a ``snapshot`` record carries the FULL folded
control-plane state (``wal_snapshot/v1``, built by
``tracker.fold_records`` / the live tracker's serializer) and replay is
snapshot + tail. A compacted journal's FIRST record is a snapshot whose
seq continues the pre-compaction numbering (seq N+1 after N folded
records) -- the implicit ``base = seq - 1`` -- so every later record
keeps one monotonic seq space across compactions. A long-lived tracker
resumes in time bounded by its LIVE state, not its history.

Durability rules follow ``engine/ckpt_store.py``:

- a FRESH log is created as ``.tmp-<pid>`` (header only), fsynced,
  ``os.replace``d onto the final name, and the directory fsynced -- a
  crash mid-create never leaves a half-written header behind;
- every :meth:`WriteAheadLog.record` appends frame+payload in one write
  and fsyncs before returning, so a transition the tracker acted on is
  on disk first (write-AHEAD, not write-behind);
- replay truncates a torn TAIL (a crash mid-append: short frame, short
  payload, or a CRC-bad FINAL record) back to the last intact record --
  that is the expected crash signature and loses only the transition
  that never completed;
- a CRC-bad or out-of-sequence record with MORE records after it is not
  a torn tail, it is silent middle-of-file corruption: replay raises
  :class:`WalCorruptError` instead of resuming from a lie;
- a magic with the right ``RBTWAL`` family but a different version
  raises :class:`WalVersionError` (an old tracker must not misparse a
  new journal, or vice versa).

Stdlib-only, no tracker imports -- the tracker depends on this module,
never the reverse (``--smoke`` and ``--compact`` import the tracker
lazily). The lease helpers are the hot standby's; nothing of the port
calls them yet.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"RBTWAL01"
_MAGIC_FAMILY = b"RBTWAL"
_FRAME = struct.Struct("<II")
LOG_NAME = "tracker.wal"
# a frame claiming more than this is treated as corruption even when
# bytes remain: no tracker transition serializes to megabytes, and the
# cap keeps a flipped length bit from provoking a giant read
MAX_RECORD_BYTES = 16 << 20

WAL_DIR_ENV = "RABIT_TRACKER_WAL_DIR"

# snapshot compaction: the record kind whose data carries
# the full folded state ({"v": "wal_snapshot/v1", "state": {...},
# "ts": wall-seconds}); replay = snapshot + tail
SNAPSHOT_KIND = "snapshot"
SNAPSHOT_V = "wal_snapshot/v1"
SNAPSHOT_EVERY_ENV = "RABIT_WAL_SNAPSHOT_EVERY"
SNAPSHOT_EVERY_DEFAULT = 0         # 0 = live compaction off


def snapshot_every() -> int:
    """``rabit_wal_snapshot_every``: journal a compacting snapshot
    after this many records since the last one (0 = never, the
    default — byte-identical journals). The tracker folds its live
    state off the hot path and atomically rewrites the journal as
    snapshot-root + future tail."""
    try:
        return max(0, int(os.environ.get(SNAPSHOT_EVERY_ENV,
                                         SNAPSHOT_EVERY_DEFAULT)))
    except ValueError:
        return SNAPSHOT_EVERY_DEFAULT


class WalError(RuntimeError):
    """Base class for journal failures."""


class WalVersionError(WalError):
    """The file is a rabit tracker WAL of a different format version."""


class WalCorruptError(WalError):
    """Non-tail corruption: a damaged or out-of-sequence record with
    intact records after it. Resuming past it would replay a forged
    history, so this is a hard error."""


def _fsync_dir(path: str) -> None:
    """Make a rename durable (rename durability is not implied by file
    durability on POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - e.g. non-POSIX dir semantics
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def encode_record(seq: int, kind: str, data: Dict[str, Any]) -> bytes:
    """Frame one journal record (canonical JSON payload: sorted keys,
    no whitespace — replay determinism is byte determinism)."""
    payload = json.dumps({"seq": int(seq), "kind": str(kind),
                          "data": data},
                         sort_keys=True, separators=(",", ":")).encode()
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def decode_record(frame: bytes) -> Tuple[int, str, Dict[str, Any]]:
    """Inverse of :func:`encode_record`: CRC-check and parse one framed
    record; raises :class:`WalCorruptError` on any damage. The ``repl``
    replication stream of the hot standby ships these exact frames, so
    the follower validates every record with the same rules replay uses."""
    if len(frame) < _FRAME.size:
        raise WalCorruptError(f"frame of {len(frame)} bytes is shorter "
                              f"than the {_FRAME.size}-byte header")
    length, crc = _FRAME.unpack_from(frame, 0)
    payload = frame[_FRAME.size:]
    if length > MAX_RECORD_BYTES:
        raise WalCorruptError(f"frame claims {length} bytes")
    if len(payload) != length:
        raise WalCorruptError(
            f"frame payload is {len(payload)} bytes, header says {length}")
    if zlib.crc32(payload) != crc:
        raise WalCorruptError("frame CRC mismatch")
    try:
        doc = json.loads(payload)
    except ValueError as e:
        raise WalCorruptError(f"unparseable frame payload: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("seq"), int) \
            or not isinstance(doc.get("kind"), str) \
            or not isinstance(doc.get("data"), dict):
        raise WalCorruptError("frame payload has the wrong shape")
    return doc["seq"], doc["kind"], doc["data"]


def recv_frame(sock) -> Optional[bytes]:
    """Read exactly one framed record off a socket (the replication
    stream's unit of transfer). Returns the raw frame bytes — header
    included, byte-identical to what :func:`encode_record` produced on
    the leader — or ``None`` on clean EOF at a frame boundary. Raises
    ``ConnectionError`` on a mid-frame EOF and
    :class:`WalCorruptError` on an insane length claim."""
    head = b""
    while len(head) < _FRAME.size:
        chunk = sock.recv(_FRAME.size - len(head))
        if not chunk:
            if head:
                raise ConnectionError("stream torn inside a frame header")
            return None
        head += chunk
    length, _ = _FRAME.unpack_from(head, 0)
    if length > MAX_RECORD_BYTES:
        raise WalCorruptError(f"stream frame claims {length} bytes")
    payload = b""
    while len(payload) < length:
        chunk = sock.recv(length - len(payload))
        if not chunk:
            raise ConnectionError("stream torn inside a frame payload")
        payload += chunk
    return head + payload


# --------------------------------------------------------------- leases
#
# Leadership is a lease RECORD in the replicated stream, not a lock in
# memory: the leader journals its CLAIM ({"owner", "until_ms"}; the
# first lease, or an owner change) and then renews every lease_ms/3.
# Renewals are idempotent — only the newest matters — so the tracker
# compacts them out of the journal and ships them to followers as
# ephemeral seq-0 heartbeat frames instead (tracker.py ``_wal``): the
# WAL, the in-memory replication log, and every future replay stay
# bounded by real transitions, not by heartbeat cadence x job duration.
#
# The follower's promotion gate deliberately does NOT compare the
# leader-stamped ``until_ms`` against its own wall clock: across hosts
# that would make the split-brain guarantee hostage to NTP (a clock
# step larger than the renewal margin could promote under a live
# leader, or pin a dead one's lease alive forever). Instead the
# follower restarts a LOCAL ``time.monotonic`` countdown of one full
# lease on every frame it receives from the leader (standby.py), and
# promotes only when that countdown lapses with the stream down — the
# gate needs no clock agreement between machines. ``lease_expired``
# below stays wall-clock and is for same-clock consumers only (the
# leader inspecting its own lease, tools, tests).

LEASE_KIND = "lease"


def lease_doc(owner: str, lease_ms: int,
              now_ms: Optional[int] = None) -> Dict[str, Any]:
    """Build one lease record's data: ``owner`` holds leadership until
    ``until_ms`` (wall-clock epoch milliseconds)."""
    if now_ms is None:
        now_ms = int(time.time() * 1000)
    return {"owner": str(owner), "until_ms": int(now_ms) + int(lease_ms),
            "lease_ms": int(lease_ms)}


def lease_expired(lease: Optional[Dict[str, Any]],
                  now_ms: Optional[int] = None) -> bool:
    """True when ``lease`` no longer holds leadership *by the caller's
    clock*. A missing or malformed lease is expired (no one holds the
    world). Same-clock consumers only: ``until_ms`` was stamped by the
    lease's OWNER, so comparing it against another host's wall clock
    inherits their skew — the standby's promotion gate uses its local
    monotonic countdown instead (see the module comment above)."""
    if now_ms is None:
        now_ms = int(time.time() * 1000)
    if not isinstance(lease, dict):
        return True
    try:
        return int(lease.get("until_ms", 0)) <= int(now_ms)
    except (TypeError, ValueError):
        return True


def lease_renewal_only(prev: Optional[Dict[str, Any]],
                       new: Dict[str, Any]) -> bool:
    """True when ``new`` merely advances ``prev``'s expiry: the same
    owner at the same width, only ``until_ms`` moved. Such renewals
    are idempotent and stay out of the journal (the claim is the
    record; renewals are stream heartbeats — see the module comment)."""
    if not isinstance(prev, dict):
        return False
    return (new.get("owner") == prev.get("owner")
            and new.get("lease_ms") == prev.get("lease_ms"))


def last_lease(records: List[Tuple[str, dict]]
               ) -> Optional[Dict[str, Any]]:
    """The newest lease in a replayed ``(kind, data)`` list, or None."""
    for kind, data in reversed(records):
        if kind == LEASE_KIND:
            return data
    return None


class WriteAheadLog:
    """One tracker's append-only journal under ``root``.

    ``open(resume=False)`` creates a fresh log (atomically, replacing
    any previous one); ``open(resume=True)`` replays the existing log —
    truncating a torn tail, raising on deeper corruption — and reopens
    it for append so the resumed tracker keeps journaling into the same
    history. All appends are serialized under an internal lock and
    fsynced before :meth:`record` returns.
    """

    def __init__(self, root: str):
        self.root = str(root)
        self.path = os.path.join(self.root, LOG_NAME)
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        # snapshot compaction: records before the snapshot
        # root are folded away — seq numbering continues from _base,
        # and snapshot_seq is the newest snapshot record's seq (0 =
        # none; the rabit_wal_snapshot_seq gauge reads it)
        self._base = 0
        self.snapshot_seq = 0
        self.records_total = 0
        self.truncated_bytes = 0

    # -- lifecycle --------------------------------------------------------
    def open(self, resume: bool = False) -> List[Tuple[str, dict]]:
        """Open the journal; returns the replayed ``(kind, data)`` list
        (empty for a fresh log)."""
        os.makedirs(self.root, exist_ok=True)
        if not resume:
            tmp = os.path.join(self.root, f".tmp-{os.getpid()}")
            with open(tmp, "wb") as f:
                f.write(MAGIC)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            _fsync_dir(self.root)
            with self._lock:
                self._fh = open(self.path, "ab")
                self._seq = 0
                self._base = 0
                self.snapshot_seq = 0
                self.records_total = 0
            return []
        records, end, base = self._scan()
        size = os.path.getsize(self.path)
        if end < size:
            # torn tail: a crash mid-append left a partial frame or a
            # CRC-bad final record — drop it and resume from the last
            # intact transition
            self.truncated_bytes = size - end
            os.truncate(self.path, end)
        snap = 0
        for i, (kind, _data) in enumerate(records):
            if kind == SNAPSHOT_KIND:
                snap = base + i + 1
        with self._lock:
            self._fh = open(self.path, "ab")
            self._seq = base + len(records)
            self._base = base
            self.snapshot_seq = snap
            self.records_total = len(records)
        return records

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # -- append -----------------------------------------------------------
    def record(self, kind: str, **data: Any) -> int:
        """Append one transition and fsync; returns its ``seq``. The
        caller must not act on the transition until this returns — the
        journal is write-AHEAD."""
        with self._lock:
            if self._fh is None:
                raise WalError("journal is not open")
            self._seq += 1
            blob = encode_record(self._seq, kind, data)
            self._fh.write(blob)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.records_total += 1
            return self._seq

    def append_encoded(self, frame: bytes) -> int:
        """Append one already-framed record (a replicated ``append``
        frame from the leader) byte-for-byte, after re-validating its
        CRC and sequence continuity; fsyncs before returning so the ack
        the follower sends back only ever covers durable records.
        Returns the record's ``seq``.

        A ``snapshot`` frame whose seq JUMPS past this journal's tail
        is a leader that compacted beyond our resync point: the
        snapshot subsumes every record we hold, so the journal is
        atomically rewritten as snapshot-root + future tail instead of
        raising (a follower must be able to adopt a compacted
        history). A contiguous snapshot frame is a plain append — a
        mid-journal snapshot replays fine."""
        seq, kind, _ = decode_record(frame)
        with self._lock:
            if self._fh is None:
                raise WalError("journal is not open")
            if seq != self._seq + 1:
                if kind == SNAPSHOT_KIND and seq > self._seq:
                    self._rewrite_locked(frame, seq)
                    return seq
                raise WalCorruptError(
                    f"replicated record has seq {seq}, journal is at "
                    f"{self._seq} (resync from the last acked seq)")
            self._fh.write(frame)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._seq = seq
            if kind == SNAPSHOT_KIND:
                self.snapshot_seq = seq
            self.records_total += 1
            return seq

    def snapshot(self, state: Dict[str, Any],
                 ts: Optional[float] = None) -> Tuple[int, bytes]:
        """Compact the journal: fold everything before ``state`` away
        by atomically rewriting the file as header + one ``snapshot``
        record whose seq CONTINUES the numbering (``base`` becomes
        seq - 1). Returns ``(seq, frame)`` — the caller publishes the
        exact frame to replication subscribers so follower journals
        stay byte-identical. ``state`` must be the fold of every
        record up to the journal's current tail (the tracker
        serializes this under its own lock; write-ahead means the
        journal never runs ahead of acted-on state)."""
        data = {"v": SNAPSHOT_V, "state": state,
                "ts": round(time.time(), 3) if ts is None else ts}
        with self._lock:
            if self._fh is None:
                raise WalError("journal is not open")
            seq = self._seq + 1
            frame = encode_record(seq, SNAPSHOT_KIND, data)
            self._rewrite_locked(frame, seq)
            return seq, frame

    def _rewrite_locked(self, frame: bytes, seq: int) -> None:
        """Atomically replace the journal with header + ``frame`` (a
        snapshot record at ``seq``); same tmp/replace/fsync dance as a
        fresh create, so a crash mid-compaction leaves either the old
        journal or the new one, never a torn hybrid."""
        tmp = os.path.join(self.root, f".tmp-{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(MAGIC + frame)
            f.flush()
            os.fsync(f.fileno())
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        os.replace(tmp, self.path)
        _fsync_dir(self.root)
        self._fh = open(self.path, "ab")
        self._seq = seq
        self._base = seq - 1
        self.snapshot_seq = seq
        self.records_total = 1

    @property
    def seq(self) -> int:
        """Sequence number of the newest durable record (0 = empty)."""
        with self._lock:
            return self._seq

    @property
    def base(self) -> int:
        """Records folded into the snapshot root (0 = never
        compacted): the journal's first record carries seq
        ``base + 1``."""
        with self._lock:
            return self._base

    # -- replay -----------------------------------------------------------
    def replay(self) -> List[Tuple[str, dict]]:
        """Parse the journal without opening it for append (tools,
        tests). Same torn-tail / corruption rules as ``open``. A
        compacted journal replays as snapshot + tail."""
        return self._scan()[0]

    def _scan(self) -> Tuple[List[Tuple[str, dict]], int, int]:
        """Returns ``(records, clean_end_offset, base)``; raises
        :class:`WalVersionError` / :class:`WalCorruptError`. ``base``
        is nonzero only for a compacted journal, whose first record is
        a snapshot continuing the pre-compaction seq numbering."""
        if not os.path.exists(self.path):
            raise WalError(f"no journal at {self.path}")
        with open(self.path, "rb") as f:
            blob = f.read()
        if len(blob) < len(MAGIC) or blob[:len(MAGIC)] != MAGIC:
            if blob[:len(_MAGIC_FAMILY)] == _MAGIC_FAMILY:
                raise WalVersionError(
                    f"journal {self.path} has version "
                    f"{blob[:len(MAGIC)]!r}, this build reads {MAGIC!r}")
            raise WalCorruptError(
                f"journal {self.path} has bad magic {blob[:8]!r}")
        records: List[Tuple[str, dict]] = []
        base = 0
        off = len(MAGIC)
        while off < len(blob):
            if off + _FRAME.size > len(blob):
                return records, off, base  # torn frame at the tail
            length, crc = _FRAME.unpack_from(blob, off)
            start = off + _FRAME.size
            end = start + length
            if length > MAX_RECORD_BYTES:
                raise WalCorruptError(
                    f"record at offset {off} claims {length} bytes")
            if end > len(blob):
                return records, off, base  # torn payload at the tail
            payload = blob[start:end]
            bad: Optional[str] = None
            doc = None
            if zlib.crc32(payload) != crc:
                bad = "CRC mismatch"
            else:
                try:
                    doc = json.loads(payload)
                except ValueError:
                    bad = "unparseable payload"
                else:
                    if not isinstance(doc, dict) or \
                            not isinstance(doc.get("seq"), int) or \
                            not isinstance(doc.get("kind"), str) or \
                            not isinstance(doc.get("data"), dict):
                        bad = (f"bad sequence/shape "
                               f"(want seq {base + len(records) + 1})")
                    else:
                        if not records and doc["seq"] > 1 and \
                                doc["kind"] == SNAPSHOT_KIND:
                            # compacted journal: the snapshot root
                            # continues the folded history's numbering
                            base = doc["seq"] - 1
                        if doc["seq"] != base + len(records) + 1:
                            bad = (f"bad sequence/shape "
                                   f"(want seq {base + len(records) + 1})")
            if bad is not None:
                if end >= len(blob):
                    # damaged FINAL record: torn tail
                    return records, off, base
                raise WalCorruptError(
                    f"record {base + len(records) + 1} at offset {off}: "
                    f"{bad} with {len(blob) - end} intact bytes after it")
            records.append((doc["kind"], doc["data"]))
            off = end
        return records, off, base


# ---------------------------------------------------------------- smoke


def _smoke() -> None:
    """``python -m rabit_tpu_torch.tracker.wal --smoke``: record/replay
    determinism, torn-tail truncation, corrupt-middle hard error, then a
    snapshot compaction -- then a LIVE
    tracker journals a 2-rank formation, crashes without cleanup, and a
    ``resume=True`` tracker on the same port re-adopts the world (same
    ranks, same epoch, zero re-registrations)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="rabit-wal-smoke-")
    try:
        # determinism: record -> replay -> identical (kind, data) list
        w = WriteAheadLog(root)
        w.open()
        wrote = [("assign", {"task": "0", "rank": 0}),
                 ("epoch", {"epoch": 1}),
                 ("skew", {"digest": {"epoch": 1, "laggard": 1}})]
        for kind, data in wrote:
            w.record(kind, **data)
        w.close()
        assert WriteAheadLog(root).replay() == wrote

        # torn tail: a partial final frame is truncated, not fatal
        with open(os.path.join(root, LOG_NAME), "ab") as f:
            f.write(b"\x40\x00\x00\x00\xde\xad")
        w2 = WriteAheadLog(root)
        assert w2.open(resume=True) == wrote and w2.truncated_bytes == 6
        w2.record("epoch", epoch=2)
        assert w2._seq == len(wrote) + 1
        w2.close()

        # corrupt middle record (CRC flip with intact bytes after it)
        # is a hard error, never a silent resume
        path = os.path.join(root, LOG_NAME)
        with open(path, "rb") as f:
            blob = bytearray(f.read())
        blob[len(MAGIC) + _FRAME.size + 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(blob)
        try:
            WriteAheadLog(root).replay()
        except WalCorruptError:
            pass
        else:
            raise AssertionError("corrupt middle record not detected")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # snapshot compaction: fold -> snapshot-root journal whose seq
    # numbering continues, tail records append past it, and a resume
    # replays snapshot + tail; a follower adopting a snapshot seq-JUMP
    # rewrites its journal instead of raising
    root = tempfile.mkdtemp(prefix="rabit-wal-smoke-")
    try:
        w = WriteAheadLog(root)
        w.open()
        for i in range(3):
            w.record("epoch", epoch=i + 1)
        seq, frame = w.snapshot({"fold": "of-3-records"})
        assert (seq, w.base, w.snapshot_seq) == (4, 3, 4), \
            (seq, w.base, w.snapshot_seq)
        assert w.record("epoch", epoch=9) == 5
        w.close()
        w = WriteAheadLog(root)
        got = w.open(resume=True)
        assert [k for k, _d in got] == [SNAPSHOT_KIND, "epoch"], got
        assert got[0][1]["state"] == {"fold": "of-3-records"}
        assert (w.seq, w.base, w.snapshot_seq) == (5, 3, 4)
        w.close()

        follower = WriteAheadLog(os.path.join(root, "follower"))
        follower.open()
        follower.record("epoch", epoch=1)   # stale tail the jump folds
        assert follower.append_encoded(frame) == 4
        assert (follower.seq, follower.base) == (4, 3)
        assert follower.replay() == [got[0]]
        follower.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # live round: journal a formation, crash, resume on the SAME port
    import socket
    import struct as _struct

    from .tracker import MAGIC as WIRE_MAGIC, Tracker

    root = tempfile.mkdtemp(prefix="rabit-wal-smoke-")

    def register(tr, task):
        c = socket.create_connection((tr.host, tr.port), timeout=10)
        c.settimeout(30)
        for v in (WIRE_MAGIC,):
            c.sendall(_struct.pack("<I", v))
        for s in ("start", task):
            b = s.encode()
            c.sendall(_struct.pack("<I", len(b)) + b)
        c.sendall(_struct.pack("<I", 0))
        b = b"127.0.0.1"
        c.sendall(_struct.pack("<I", len(b)) + b)
        c.sendall(_struct.pack("<I", 9000 + int(task)))
        c.sendall(_struct.pack("<I", 0))
        c.sendall(_struct.pack("<I", 0))  # empty uds_token
        return c

    def drain_assignment(c):
        def u32():
            out = b""
            while len(out) < 4:
                chunk = c.recv(4 - len(out))
                assert chunk, "tracker closed mid-assignment"
                out += chunk
            return _struct.unpack("<I", out)[0]

        def skip_str():
            n = u32()
            got = 0
            while got < n:
                got += len(c.recv(n - got))

        rank, world, epoch = u32(), u32(), u32()
        skip_str(); u32(); u32(); u32()
        for _ in range(u32()):
            u32()
        u32(); u32()
        for _ in range(u32()):
            u32(); skip_str(); u32(); skip_str()
        u32()
        c.sendall(_struct.pack("<I", 1))  # ready ack
        c.close()
        return rank, world, epoch

    import time
    tr = Tracker(2, wal_dir=root).start()
    try:
        conns = []
        for i in range(2):
            # one at a time: ranks go by the order of registration
            conns.append(register(tr, str(i)))
            deadline = time.monotonic() + 10
            while str(i) not in tr._ranks:
                assert time.monotonic() < deadline, "never registered"
                time.sleep(0.01)
        got = sorted(drain_assignment(c) for c in conns)
        assert got == [(0, 2, 1), (1, 2, 1)], got
        port = tr.port
        tr.crash()  # no graceful flush, no journal close

        deadline = time.monotonic() + 10
        while True:
            try:
                res = Tracker(2, host=tr.host, port=port, wal_dir=root,
                              resume=True)
                break
            except OSError:
                # the dead incarnation's listen socket can linger a
                # beat past crash(); the pinned port must win
                assert time.monotonic() < deadline, "port never freed"
                time.sleep(0.05)
        res.start()
        try:
            assert res.port == port
            assert res._ranks == {"0": 0, "1": 1}, res._ranks
            assert res._epoch == 1, res._epoch
            assert res.restarts == 1, res.restarts
            assert res.wal_records() > 0
        finally:
            res.stop()
    finally:
        tr.stop()
        shutil.rmtree(root, ignore_errors=True)
    print("wal smoke ok")


# ------------------------------------------------------------ inspection


def inspect_journal(root: str) -> Dict[str, Any]:
    """One journal directory's health: per-kind record counts, last
    seq, lease state, torn-tail status. Never raises on a damaged
    journal — the whole point is debugging one."""
    doc: Dict[str, Any] = {"dir": root, "records": 0, "kinds": {},
                           "last_seq": 0, "lease": None,
                           "lease_expired": None, "torn_tail_bytes": 0,
                           "base": 0, "snapshot_seq": 0,
                           "snapshot_age_s": None, "tail_records": 0,
                           "error": None}
    log = WriteAheadLog(root)
    try:
        records, clean_end, base = log._scan()
    except WalError as e:
        doc["error"] = f"{type(e).__name__}: {e}"
        return doc
    doc["records"] = len(records)
    doc["last_seq"] = base + len(records)
    doc["base"] = base
    doc["tail_records"] = len(records)
    kinds: Dict[str, int] = {}
    for i, (kind, data) in enumerate(records):
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == SNAPSHOT_KIND:
            doc["snapshot_seq"] = base + i + 1
            doc["tail_records"] = len(records) - i - 1
            ts = data.get("ts")
            if isinstance(ts, (int, float)):
                doc["snapshot_age_s"] = round(
                    max(0.0, time.time() - ts), 3)
    doc["kinds"] = kinds
    lease = last_lease(records)
    if lease is not None:
        doc["lease"] = lease
        doc["lease_expired"] = lease_expired(lease)
    try:
        doc["torn_tail_bytes"] = max(
            0, os.path.getsize(log.path) - clean_end)
    except OSError:
        pass
    return doc


def inspect_dir(wal_dir: str) -> Dict[str, Any]:
    """Inspect a tracker WAL directory tree: the root journal plus
    every per-job namespace underneath it (``<wal_dir>/<job_id>/``, which
    a multi-job tracker writes) and the standby's replica when
    present."""
    out: Dict[str, Any] = {"root": None, "jobs": {}}
    if os.path.exists(os.path.join(wal_dir, LOG_NAME)):
        out["root"] = inspect_journal(wal_dir)
    try:
        subdirs = sorted(os.listdir(wal_dir))
    except OSError:
        subdirs = []
    for name in subdirs:
        sub = os.path.join(wal_dir, name)
        if os.path.isdir(sub) and \
                os.path.exists(os.path.join(sub, LOG_NAME)):
            out["jobs"][name] = inspect_journal(sub)
    return out


def _print_inspection(doc: Dict[str, Any]) -> None:
    def fmt(tag: str, j: Dict[str, Any]) -> None:
        if j.get("error"):
            print(f"{tag}: UNREADABLE — {j['error']}")
            return
        kinds = ", ".join(f"{k}={n}" for k, n in
                          sorted(j["kinds"].items())) or "(empty)"
        torn = (f", torn tail {j['torn_tail_bytes']}B"
                if j["torn_tail_bytes"] else "")
        lease = ""
        if j["lease"] is not None:
            state = ("EXPIRED" if j["lease_expired"] else "live")
            lease = (f", lease {state} "
                     f"(owner {j['lease'].get('owner')})")
        snap = ""
        if j.get("snapshot_seq"):
            age = j.get("snapshot_age_s")
            age_s = f", {age:.0f}s old" if age is not None else ""
            snap = (f", snapshot at seq {j['snapshot_seq']}{age_s} "
                    f"(+{j['tail_records']} tail records)")
        print(f"{tag}: seq {j['last_seq']}, {kinds}{torn}{lease}{snap}")

    if doc["root"] is None:
        print("(no root journal)")
    else:
        fmt("root", doc["root"])
    for name, j in sorted(doc["jobs"].items()):
        fmt(f"job {name}" if name != "standby" else "standby replica",
            j)


def compact_dir(wal_dir: str, nworkers: int = 1,
                elastic: bool = False) -> Dict[str, Any]:
    """Offline compaction of a COLD journal (no tracker may be
    appending): fold every record into one ``wal_snapshot/v1`` state
    doc via the tracker's own replay fold — shared code, so offline
    compaction can never drift from live replay semantics — and
    rewrite the journal as snapshot-root. ``nworkers``/``elastic``
    must match the tracker launch shape, exactly as ``--resume``
    itself requires. Returns ``{folded, seq}``."""
    from .tracker import fold_records   # lazy: wal must not import tracker
    log = WriteAheadLog(wal_dir)
    records = log.open(resume=True)
    try:
        state = fold_records(records, nworkers=nworkers,
                             elastic=elastic)
        seq, _frame = log.snapshot(state)
    finally:
        log.close()
    return {"folded": len(records), "seq": seq}


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys as _sys
    ap = argparse.ArgumentParser(
        description="Tracker WAL tools: --smoke, "
                    "--inspect <dir> (per-job record counts, last "
                    "seq, lease state, snapshot age, torn-tail "
                    "status), or --compact <dir> (offline snapshot "
                    "of a cold journal: replay becomes snapshot + "
                    "tail).")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--inspect", metavar="WAL_DIR", default=None)
    ap.add_argument("--compact", metavar="WAL_DIR", default=None)
    ap.add_argument("--nworkers", type=int, default=1,
                    help="--compact: the tracker launch world size "
                         "(folds like a resume with this shape)")
    ap.add_argument("--elastic", action="store_true",
                    help="--compact: fold with elastic membership on")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable --inspect output")
    args = ap.parse_args(argv)
    if args.smoke:
        _smoke()
        return 0
    if args.compact:
        try:
            out = compact_dir(args.compact, nworkers=args.nworkers,
                              elastic=args.elastic)
        except WalError as e:
            print(f"compaction failed: {e}", file=_sys.stderr)
            return 1
        print(f"compacted {out['folded']} records into a snapshot "
              f"at seq {out['seq']} ({args.compact})")
        return 0
    if args.inspect:
        doc = inspect_dir(args.inspect)
        if args.json:
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            _print_inspection(doc)
        return 0 if not (doc["root"] or {}).get("error") else 1
    ap.print_help(_sys.stderr)
    return 2


if __name__ == "__main__":
    import importlib
    import sys
    # run the package's copy of this module, not this ``__main__`` one,
    # so that the errors the tracker's fold raises are the classes
    # ``_main`` catches
    sys.exit(importlib.import_module(__spec__.name)._main())

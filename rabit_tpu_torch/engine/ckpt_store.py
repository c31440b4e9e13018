"""The port's copy of ``rabit_tpu/engine/ckpt_store.py``: the durable
on-disk checkpoint mirror for cold restart.

The rabit recovery model keeps checkpoints in memory, replicated across
``rabit_global_replica`` ring neighbours — which survives any *partial*
failure but loses everything when the whole world dies (power cut,
preemption sweep, gang-scheduled eviction). The store closes that gap:
when ``rabit_ckpt_dir`` is set, every ``checkpoint()`` also lands in

    <rabit_ckpt_dir>/r<rank>/ckpt_v<version>.rbt

and a restarted world reloads the newest intact version instead of
starting from scratch (``doc/fault_tolerance.md`` describes the
cold-restart consensus that sits on top).

File format (all integers little-endian)::

    8s   magic "RBTCKPT1"             (version-prefixed: bump on change)
    Q    checkpoint version number
    Q    len(global payload)
    Q    len(local payload)
    I    crc32(global payload)
    I    crc32(local payload)
    ...  global payload, local payload

Durability rules, in the order that makes each one meaningful:

- write to ``.tmp-<pid>`` in the same directory, ``fsync`` the file,
  then ``os.replace`` onto the final name — a crash mid-write leaves
  the previous version untouched, never a half-written current one;
- the directory is fsynced after the rename so the *name* is durable
  too (rename durability is not implied by file durability on POSIX);
- loads verify magic, lengths, and both CRCs, and a corrupt file is
  skipped with a warning while older versions stay eligible — torn or
  bit-flipped checkpoints degrade to "restart from the previous one",
  never to garbage model state.

Stdlib-only and engine-agnostic: the XLA engine mirrors its in-memory
checkpoint dict through it, the native engine wraps it around the C++
checkpoint payloads.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

from ..utils import log

MAGIC = b"RBTCKPT1"
_HEADER = struct.Struct("<8sQQQII")
_PREFIX = "ckpt_v"
_SUFFIX = ".rbt"
DEFAULT_KEEP = 2


def encode_record(version: int, global_payload: bytes,
                  local_payload: bytes = b"") -> bytes:
    """Serialize one checkpoint (also used by the native engine to wrap
    version metadata *inside* the replicated payload, so the absolute
    version rides the ring's own replay machinery)."""
    g = bytes(global_payload)
    l = bytes(local_payload)
    return _HEADER.pack(MAGIC, int(version), len(g), len(l),
                        zlib.crc32(g), zlib.crc32(l)) + g + l


def decode_record(blob: bytes) -> Tuple[int, bytes, bytes]:
    """Parse + verify one record; raises ``ValueError`` on any
    corruption (bad magic, short read, CRC mismatch)."""
    if len(blob) < _HEADER.size:
        raise ValueError(f"checkpoint record truncated: {len(blob)} bytes")
    magic, version, glen, llen, gcrc, lcrc = _HEADER.unpack_from(blob)
    if magic != MAGIC:
        raise ValueError(f"bad checkpoint magic {magic!r}")
    end = _HEADER.size + glen + llen
    if len(blob) != end:
        raise ValueError(f"checkpoint record length mismatch: "
                         f"{len(blob)} != {end}")
    g = blob[_HEADER.size:_HEADER.size + glen]
    l = blob[_HEADER.size + glen:end]
    if zlib.crc32(g) != gcrc:
        raise ValueError("global payload CRC mismatch")
    if zlib.crc32(l) != lcrc:
        raise ValueError("local payload CRC mismatch")
    return int(version), g, l


def is_wrapped(payload: bytes) -> bool:
    """True when ``payload`` is an :func:`encode_record` blob (the
    native engine uses this to recognise wrapped checkpoints coming
    back from C++ replay)."""
    return payload[:len(MAGIC)] == MAGIC


class CheckpointStore:
    """Per-rank durable checkpoint directory with atomic writes and
    verified loads."""

    def __init__(self, root: str, rank: int = 0, keep: int = DEFAULT_KEEP):
        self.root = root
        self.rank = int(rank)
        self.keep = max(1, int(keep))
        self.dir = os.path.join(root, f"r{self.rank}")
        # resize protection: the newest version
        # written at the OLD world size is pinned across an elastic
        # resize until the new world commits its first checkpoint —
        # without the pin, `keep` new-world saves on a fast rank can
        # prune the only version a slower rank still shares, and a
        # subsequent cold restart has no common version to agree on.
        self._protected: Optional[int] = None
        os.makedirs(self.dir, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def path_for(self, version: int) -> str:
        return os.path.join(self.dir, f"{_PREFIX}{int(version)}{_SUFFIX}")

    def versions(self) -> List[int]:
        """Stored versions, ascending (by filename; contents are only
        verified at load)."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for name in names:
            if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
                try:
                    out.append(int(name[len(_PREFIX):-len(_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    # -- write ------------------------------------------------------------
    def save(self, version: int, global_payload: bytes,
             local_payload: bytes = b"") -> str:
        """Durably persist one checkpoint; returns the final path."""
        blob = encode_record(version, global_payload, local_payload)
        final = self.path_for(version)
        tmp = os.path.join(self.dir, f".tmp-{os.getpid()}")
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, blob)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, final)
        self._fsync_dir()
        # a durable post-resize save IS the new world's first committed
        # checkpoint: the old-world pin has served its purpose
        self._protected = None
        self.prune()
        return final

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.dir, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        except OSError:
            pass
        finally:
            os.close(dfd)

    def prune(self) -> List[int]:
        """Drop all but the newest ``keep`` versions; returns what was
        removed. Never removes the file it cannot list past, and never
        the version pinned by :meth:`protect_current` (the newest
        old-world checkpoint of an in-flight elastic resize)."""
        vs = self.versions()
        doomed = vs[:-self.keep] if len(vs) > self.keep else []
        doomed = [v for v in doomed if v != self._protected]
        for v in doomed:
            try:
                os.unlink(self.path_for(v))
            except OSError:
                pass
        return doomed

    def protect_current(self) -> Optional[int]:
        """Pin the newest stored version against pruning until the
        next :meth:`save` lands (engines call this when the world
        resizes: ``rabit_ckpt_keep`` must not drop the newest version
        written at the old world size while the new world has not yet
        committed its first checkpoint). Returns the pinned version,
        or None when the store is empty."""
        vs = self.versions()
        self._protected = vs[-1] if vs else None
        return self._protected

    @property
    def protected_version(self) -> Optional[int]:
        return self._protected

    # -- elastic shard redistribution -------------------------------------
    def adopt_latest_from_peers(self) -> Optional[int]:
        """Seed this rank's directory from a sibling rank's shards: a
        joiner re-admitted into an elastic world may have an empty (or
        stale) store while the survivors' newest version moved on. The
        global payload is world-replicated, so any sibling's newest
        intact record is a valid seed — REDISTRIBUTED from the durable
        store, not replayed from scratch. Copies only when a sibling
        holds a strictly newer version; the adopted version is
        immediately pinned (see :meth:`protect_current`). Returns the
        adopted version, or None when nothing newer exists."""
        mine = self.latest_version()
        best: Optional[Tuple[int, "CheckpointStore"]] = None
        try:
            names = os.listdir(self.root)
        except OSError:
            return None
        for name in sorted(names):
            if not name.startswith("r") or name == f"r{self.rank}":
                continue
            try:
                peer_rank = int(name[1:])
            except ValueError:
                continue
            peer = CheckpointStore(self.root, peer_rank, keep=self.keep)
            v = peer.latest_version()
            if v > mine and (best is None or v > best[0]):
                best = (v, peer)
        if best is None:
            return None
        version, peer = best
        got = peer.load(version)
        if got is None:
            return None
        self.save(version, got[0], got[1])
        self._protected = version
        log.log_warn("ckpt_store: rank %d adopted v%d from rank %d "
                     "(elastic shard redistribution)", self.rank,
                     version, peer.rank)
        return version

    # -- read -------------------------------------------------------------
    def load(self, version: int) -> Optional[Tuple[bytes, bytes]]:
        """(global, local) for ``version``; None when missing or
        corrupt (corruption is logged, not raised — the caller falls
        back to an older version)."""
        path = self.path_for(version)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        try:
            v, g, l = decode_record(blob)
            if v != int(version):
                raise ValueError(f"header says v{v}, filename says "
                                 f"v{version}")
        except ValueError as e:
            log.log_warn("ckpt_store: skipping corrupt %s (%s)", path, e)
            return None
        return g, l

    def latest(self) -> Optional[Tuple[int, bytes, bytes]]:
        """Newest *intact* checkpoint as (version, global, local), or
        None when the store is empty or fully corrupt."""
        for v in reversed(self.versions()):
            got = self.load(v)
            if got is not None:
                return v, got[0], got[1]
        return None

    def latest_version(self) -> int:
        """Newest intact version number, or 0 — the value each rank
        contributes to the cold-restart MAX-consensus allreduce."""
        got = self.latest()
        return got[0] if got is not None else 0

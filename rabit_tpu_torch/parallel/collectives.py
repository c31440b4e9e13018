"""Collectives over a ``torch.distributed`` process group: the port of
``rabit_tpu/parallel/collectives.py``'s schedules.

Each function runs in every rank of ``group`` (``None`` is the default
group) on this rank's own tensor, where the JAX versions run per shard
inside ``shard_map`` over a mesh axis. The schedules follow the JAX
package's send order, fold order (``combine(cur, got)``) and wire
contract, so unquantized f32 results carry the JAX schedules' bits:

* ``tree_allreduce`` -- the library's reduction (``dist.all_reduce``),
  the latency-optimal schedule; BITOR, which NCCL lacks, is an
  all-gather and a local fold, as in the JAX version.
* ``ring_reduce_scatter`` / ``ring_all_gather`` / ``ring_allreduce`` --
  the bandwidth-optimal ring as explicit point-to-point exchanges
  (``dist.batch_isend_irecv``) with the JAX ring's chunk offsets, so
  rank i owns chunk i. ``reverse`` walks the counter-rotating ring;
  ``groups`` (equal-size tuples of ranks partitioning the group) runs
  the same schedule over every sub-ring at once. Sub-rings need no
  process groups of their own: they are exchanges between ranks.
* ``bidir_ring_allreduce`` -- two counter-rotating rings, each with half
  the payload, whose exchanges are posted together a step.
* ``swing_allreduce`` -- the Swing schedule (arXiv:2401.09356) over
  ``_swing_tables``; a world that is not a power of two runs the ring.
* ``hier_allreduce`` -- intra-group reduce-scatter, inter-group ring or
  swing over the slot rings, intra-group all-gather.
* ``preagg_allreduce`` -- pre-aggregation around a known laggard.
* ``allreduce`` -- the dispatcher: host grouping
  (``parallel/topology.py``), then ``dispatch.resolve``, then the
  schedule.
* ``bcast_from_root`` and ``shard_over``.
* the device entry points of the JAX package, each rank on its own
  tensor: ``device_reduce_scatter``, ``device_allgather``,
  ``device_hier_allreduce`` (three phases, each under ``phase_guard``),
  ``bucket_allreduce`` and ``device_allreduce_tree`` (one buffer per
  dtype, leaves in JAX's flatten order), ``device_broadcast``
  (``allreduce`` is ``device_allreduce``);
* the async layer: ``device_allreduce_async``,
  ``grad_bucket_allreduce_async``, ``bucket_allreduce_async`` and
  ``device_hier_allreduce_async`` return an ``AsyncHandle`` (or an
  ``AsyncTreeHandle``) in a bounded window (``async_max_inflight``);
  ``grad_buckets_async`` issues a gradient dict's buckets for the models;
  ``async_enabled`` and ``configure_async`` read and set the knobs. How
  it keeps every rank's collectives in one order, issues without waiting
  on the card, and hands back the sync bits: the section's comment.
* ``psum_identity_grad`` / ``ident_psum_grad`` (Megatron's conjugate
  pair) and ``ring_shift`` (one differentiable ring rotation): autograd
  Functions for the transformer's tensor- and sequence-parallel regions.

Telemetry (``rabit_tpu_torch.telemetry``, off unless ``rabit_telemetry``
/ ``rabit_profile``): every host-level entry point -- ``allreduce``,
``device_reduce_scatter``, ``device_allgather``, ``device_hier_allreduce``
(a span a phase, one ``round``), ``device_allreduce_tree``,
``device_broadcast`` and the ``*_async`` issues -- records the JAX
package's span with its analytic cost (``cost_*`` attributes); while a
span is live the entry point waits for its result (an event on the
result's stream) so that the span times the collective, and stamps
``wire_exposed_ms`` / ``wire_overlapped_ms``. An ``AsyncHandle`` records
its span at ``wait()`` with the measured split. The schedules the models
call (``tree_allreduce``, ``ring_allreduce``, ``bidir_ring_allreduce``,
``swing_allreduce``, ``hier_allreduce``, ``preagg_allreduce``) get only
JAX's ``rabit_*`` labels (``telemetry.trace_annotation``), which add no
operation and no wait.

``wire`` (``parallel/wire.py``) compresses only the exchanged bytes of
float SUM payloads: every received contribution decodes to f32 and folds
in f32, and the all-gather owner encodes its chunk once, the encoding
travelling verbatim, so every rank ends bit-identical.

NCCL point-to-point: every rank of a pair posts its side of each
exchange in the same order, and a communicator's first operation must
include every rank -- callers warm a fresh group with one collective
(the sweep and the bench do) before a schedule whose first exchange
leaves ranks out (``preagg``).

Unsigned payloads: PyTorch's uint16/32/64 support few operations and no
backend reduces them, so they travel as the signed type of the same
width. SUM and BITOR give the same bits that way; for MAX and MIN the sign
bit is flipped first (which maps unsigned order onto signed order) and
flipped back after.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
import warnings
import weakref
from dataclasses import dataclass
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry
from ..convert import numpy_from_tensor, tensor_from_numpy
from ..telemetry import profile as _profile
from ..telemetry import skew as _skew
from ..ops.reducers import BITOR, MAX, MIN, OP_NAMES, SUM, torch_reduce_fn
from . import dispatch as _dispatch
from . import topology as _topology
from .wire import (canonical_wire as _canonical_wire, decode as _decode,
                   encode as _encode, format_wire as _format_wire,
                   parse_wire as _parse_wire)

_REDUCE_OPS = {SUM: dist.ReduceOp.SUM, MAX: dist.ReduceOp.MAX,
               MIN: dist.ReduceOp.MIN}
_SIGNED_OF = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}


def _as_reducible(x: torch.Tensor, op: int
                  ) -> Tuple[torch.Tensor, Callable[[torch.Tensor],
                                                    torch.Tensor]]:
    """``x`` in a dtype every backend reduces, and the map back."""
    signed = _SIGNED_OF.get(x.dtype)
    if signed is None:
        return x, lambda y: y
    unsigned = x.dtype
    if op in (MAX, MIN):
        flip = torch.iinfo(signed).min
        return (x.view(signed) ^ flip,
                lambda y: (y ^ flip).view(unsigned))
    return x.view(signed), lambda y: y.view(unsigned)


def _post(exchanges: Sequence[Tuple[Sequence[torch.Tensor],
                                    Sequence[torch.Tensor],
                                    Optional[int], Optional[int]]],
          group) -> None:
    """Run point-to-point exchanges as one batch and wait for them: each
    entry ``(sends, recvs, to, frm)`` sends its tensors to rank ``to`` of
    ``group`` and receives into ``recvs`` from rank ``frm`` (None: nothing
    that way). Entry e's i-th tensor travels under tag 16 e + i, which
    keeps the tensors of one entry, and two entries between the same two
    ranks, apart on gloo (which matches by peer and tag); NCCL matches in
    posting order, which every rank shares."""
    g = group if group is not None else dist.group.WORLD
    ops = []
    for e, (sends, recvs, to, frm) in enumerate(exchanges):
        if to is not None:
            peer = dist.get_global_rank(g, to)
            ops += [dist.P2POp(dist.isend, t, peer, group, 16 * e + i)
                    for i, t in enumerate(sends)]
        if frm is not None:
            peer = dist.get_global_rank(g, frm)
            ops += [dist.P2POp(dist.irecv, t, peer, group, 16 * e + i)
                    for i, t in enumerate(recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _exchange(send: Sequence[torch.Tensor], to: Optional[int],
              frm: Optional[int], group) -> List[torch.Tensor]:
    """Send the tensors of ``send`` to ``to`` while receiving tensors of
    the same shapes from ``frm`` (one ``ppermute`` step of the JAX
    schedules); returns what arrived."""
    got = [torch.empty_like(t) for t in send]
    _post([(send, got, to, frm)], group)
    return got


def _allreduce_label(method: str, wire: Optional[str]) -> str:
    """JAX's profile label of a schedule (``collectives.py:873-878``): the
    wire spec's separators (``:@``) as underscores."""
    wtag = wire.replace(":", "_").replace("@", "_") if wire else ""
    return f"rabit_allreduce_{method}" + (f"_{wtag}" if wtag else "")


def _annotated(method: str):
    """Run the decorated schedule (``fn(x, group, op, [wire], ...)``) under
    its ``rabit_allreduce_<method>`` label when telemetry is on."""
    def deco(fn):
        @functools.wraps(fn)
        def run(x, group=None, op=SUM, *args, **kw):
            if not telemetry.enabled():
                return fn(x, group, op, *args, **kw)
            wire = kw.get("wire", args[0] if args else None)
            with telemetry.trace_annotation(_allreduce_label(method, wire)):
                return fn(x, group, op, *args, **kw)
        return run
    return deco


def _cost_attrs(cost) -> dict:
    """A ``profile.record_cost`` estimate as span attributes (none when
    profiling is off)."""
    return ({"cost_flops": cost["flops"], "cost_wire_bytes": cost["wire_bytes"],
             "cost_hops": cost["hops"]} if cost else {})


def _stamp_exposed(sp, t0: float) -> None:
    """A synchronous collective blocks its caller for its whole span: all
    of it exposed, nothing overlapped (``collectives.py:972-983`` of the
    JAX package); the async handles stamp the measured split instead."""
    sp.attrs["wire_exposed_ms"] = (time.perf_counter() - t0) * 1e3
    sp.attrs["wire_overlapped_ms"] = 0.0


def _finish(sp, out, t0: float) -> None:
    """Close out a live span's measurement: wait for ``out`` (a tensor or a
    tree of them) on its stream, as JAX's ``block_until_ready``, then stamp
    the split. A span that is not live costs nothing here: no wait."""
    if not sp.live:
        return
    leaves = _flatten(out)[0] if not isinstance(out, torch.Tensor) else [out]
    if leaves and leaves[0].is_cuda:
        dev = leaves[0].device
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
    _stamp_exposed(sp, t0)


def _group_tables(groups, p: int):
    """Tables for grouped (sub-ring) schedules: ``groups`` must
    partition ``range(p)`` into equal-size rings (the JAX package runs
    one program on every rank, so every sub-ring has one length; the
    port keeps that contract). Returns ``(size, local_of)``: the common
    ring length and each rank's position around its own ring."""
    flat = [r for grp in groups for r in grp]
    if sorted(flat) != list(range(p)):
        raise ValueError(
            f"groups {groups!r} must partition ranks 0..{p - 1}")
    sizes = {len(grp) for grp in groups}
    if len(sizes) != 1:
        raise ValueError(
            f"grouped schedules need uniform group sizes, got {groups!r}")
    local_of = [0] * p
    for grp in groups:
        for j, r in enumerate(grp):
            local_of[r] = j
    return next(iter(sizes)), tuple(local_of)


def _my_ring(group, groups) -> Tuple[Tuple[int, ...], int]:
    """This rank's ring (the whole group, or its own sub-ring of
    ``groups``) as ranks of ``group`` in ring order, and its position."""
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    if groups is None:
        return tuple(range(p)), idx
    _, local_of = _group_tables(groups, p)
    ring = next(tuple(grp) for grp in groups if idx in grp)
    return ring, local_of[idx]


def _normalize_wire(wire, op: int, dtype: torch.dtype, chunk_len=None):
    """One policy for wire eligibility, used by every ring entry point:
    quantized wire applies only to float SUM payloads; int8 phases need
    the per-rank chunk to tile into scaling blocks (else degrade that
    phase to bf16). ``chunk_len=None`` skips the block check, for callers
    that pad the chunk up to a block multiple themselves. Returns the
    canonical spec string or None."""
    if wire is None:
        return None
    rs, ag, block = _parse_wire(wire)  # raises on malformed specs
    if op != SUM or not dtype.is_floating_point:
        return None
    if chunk_len is not None and chunk_len % block != 0:
        rs = "bf16" if rs == "int8" else rs
        ag = "bf16" if ag == "int8" else ag
    return _format_wire(rs, ag, block)


def _wire_pad_mult(wire, size: int) -> int:
    """Chunk-alignment multiple for pad-and-slice entry points: any int8
    phase needs the per-rank chunk to tile into scaling blocks."""
    if not wire:
        return size
    rs, ag, block = _parse_wire(wire)
    return size * block if "int8" in (rs, ag) else size


def _pad_to_multiple(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[0]
    rem = (-n) % p
    if rem:
        x = torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])
    return x, n


def _check_flat(x: torch.Tensor, name: str, op: int = SUM) -> None:
    if x.dim() != 1:
        raise ValueError(f"{name} takes a 1-D tensor, got shape "
                         f"{tuple(x.shape)}; flatten first")
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op}")


@_annotated("tree")
def tree_allreduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                   op: int = SUM) -> torch.Tensor:
    """Latency-optimal allreduce: the backend's own reduction
    (TryAllreduceTree equivalent, allreduce_base.cc:475-640). Returns a
    new tensor; ``x`` is left as it was."""
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op}")
    y, back = _as_reducible(x.contiguous(), op)
    if op == BITOR:
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        return back(functools.reduce(torch.bitwise_or, parts))
    y = y.clone()
    dist.all_reduce(y, op=_REDUCE_OPS[op], group=group)
    return back(y)


# ---------------------------------------------------------------------------
# The ring. A lane is one ring's state; several lanes (the two halves of
# the bidirectional ring) step together, their exchanges posted as one
# batch a step, so that the two directions of each link carry data at once.
# ---------------------------------------------------------------------------

@dataclass
class _Lane:
    buf: torch.Tensor          # [size, m]: chunks (RS) or the output (AG)
    ring: Tuple[int, ...]      # ranks of the group, in ring order
    pos: int                   # this rank's position on the ring
    reverse: bool

    @property
    def size(self) -> int:
        return len(self.ring)

    def peers(self) -> Tuple[int, int]:
        """(to, frm): the ranks this lane sends to and receives from."""
        d = -1 if self.reverse else 1
        return (self.ring[(self.pos + d) % self.size],
                self.ring[(self.pos - d) % self.size])


def _rs_lanes(lanes: Sequence[_Lane], group, op: int,
              codec: Optional[str], block: int) -> None:
    """Ring reduce-scatter over every lane in place. At step s a forward
    lane sends chunk (pos-s-1) mod size (accumulated so far) and folds
    what arrives into chunk (pos-s-2) mod size; a reverse lane mirrors the
    offsets (pos+s+1, pos+s+2). After size-1 steps the lane's chunk
    ``pos`` is fully reduced (JAX ``ring_reduce_scatter``'s schedule)."""
    combine = torch_reduce_fn(op)
    size = lanes[0].size
    for step in range(size - 1):
        plan, outs = [], []
        for ln in lanes:
            sgn = 1 if ln.reverse else -1
            send_i = (ln.pos + sgn * (step + 1)) % size
            recv_i = (ln.pos + sgn * (step + 2)) % size
            send = ln.buf[send_i]
            enc = (send,) if codec is None else _encode(send, codec, block)
            got = [torch.empty_like(t) for t in enc]
            plan.append((enc, got, *ln.peers()))
            outs.append((ln, recv_i, got))
        _post(plan, group)
        for ln, recv_i, got in outs:
            got = got[0] if codec is None else _decode(
                got, codec, ln.buf[recv_i].shape)
            ln.buf[recv_i] = combine(ln.buf[recv_i], got)


def _ag_start(x: torch.Tensor, codec: Optional[str], block: int):
    """The all-gather owner's side: its chunk as every other rank will
    decode it, and the encoding it ships (encoded once, here)."""
    if codec is None:
        return x, None
    enc = _encode(x, codec, block)
    return _decode(enc, codec, x.shape).to(x.dtype), enc


def _ag_lanes(lanes: Sequence[_Lane], group, codec: Optional[str],
              encs: List) -> None:
    """Ring all-gather over every lane in place: each lane's ``buf`` holds
    this rank's chunk at ``pos`` (``_ag_start``'s decode) and ends holding
    every chunk. With a codec each hop forwards the encoding it received
    verbatim, starting from the owner's ``encs[j]``: decoding is
    deterministic in the bytes, so every rank ends bit-identical
    (re-encoding a hop would drift the int8 scales by ULPs)."""
    size = lanes[0].size
    for step in range(size - 1):
        plan, outs = [], []
        for j, ln in enumerate(lanes):
            sgn = 1 if ln.reverse else -1
            send_i = (ln.pos + sgn * step) % size
            recv_i = (ln.pos + sgn * (step + 1)) % size
            if codec is None:
                plan.append(([ln.buf[send_i]], [ln.buf[recv_i]],
                             *ln.peers()))
            else:
                # the chunk sent at step s is the one received at step
                # s-1 (the own chunk at s=0): forward its encoding
                got = [torch.empty_like(t) for t in encs[j]]
                plan.append((encs[j], got, *ln.peers()))
                outs.append((j, ln, recv_i, got))
        _post(plan, group)
        for j, ln, recv_i, got in outs:
            encs[j] = got
            ln.buf[recv_i] = _decode(got, codec, ln.buf[recv_i].shape).to(
                ln.buf.dtype)


def _ring_allreduce_lanes(parts: Sequence[torch.Tensor],
                          ring: Tuple[int, ...], pos: int,
                          reverses: Sequence[bool], group, op: int,
                          wire: Optional[str]) -> List[torch.Tensor]:
    """Reduce-scatter then all-gather of each part (length a multiple of
    the ring's size, and of the int8 block times it) on its own lane, the
    lanes stepping together. Returns each part reduced, flat."""
    rs_codec, ag_codec, block = (_parse_wire(wire) if wire
                                 else (None, None, 0))
    size = len(ring)
    acc = torch.float32 if rs_codec else parts[0].dtype
    lanes = [_Lane(x.reshape(size, -1).to(acc, copy=True), ring, pos, rev)
             for x, rev in zip(parts, reverses)]
    _rs_lanes(lanes, group, op, rs_codec, block)
    encs = []
    for ln, x in zip(lanes, parts):
        own, enc = _ag_start(ln.buf[pos].to(x.dtype), ag_codec, block)
        ln.buf = torch.empty((size, own.shape[0]), dtype=x.dtype,
                             device=x.device)
        ln.buf[pos] = own
        encs.append(enc)
    _ag_lanes(lanes, group, ag_codec, encs)
    return [ln.buf.reshape(-1) for ln in lanes]


def ring_reduce_scatter(x: torch.Tensor,
                        group: Optional[dist.ProcessGroup] = None,
                        op: int = SUM, wire: Optional[str] = None,
                        reverse: bool = False, groups=None) -> torch.Tensor:
    """Ring reduce-scatter: every rank contributes ``x`` (length n,
    divisible by the ring size) and ends owning chunk ``position`` (length
    n/size) fully reduced, after size-1 exchanges of n/size elements each
    (allreduce_base.cc:829-918).

    ``wire`` compresses the exchanged bytes only ("bf16", or "int8"
    block-scaled, float SUM only); received contributions fold in f32 and
    the result is cast back at the end. ``reverse`` runs the mirror
    schedule around the counter-rotating ring; ownership still lands on
    chunk == position. ``groups`` runs the schedule over every sub-ring at
    once: each rank reduces with its own group and owns chunk ``local
    index`` of the group-size split."""
    _check_flat(x, "ring_reduce_scatter", op)
    ring, pos = _my_ring(group, groups)
    size = len(ring)
    if size == 1:
        return x
    if x.shape[0] % size:
        raise ValueError(f"ring_reduce_scatter length {x.shape[0]} does "
                         f"not divide by the ring size {size}")
    wire = _normalize_wire(wire, op, x.dtype, x.shape[0] // size)
    rs_codec, _, block = _parse_wire(wire) if wire else (None, None, 0)
    y, back = _as_reducible(x.contiguous(), op)
    acc = torch.float32 if rs_codec else y.dtype
    lane = _Lane(y.reshape(size, -1).to(acc, copy=True), ring, pos, reverse)
    _rs_lanes([lane], group, op, rs_codec, block)
    return back(lane.buf[pos].to(y.dtype, copy=True))


def ring_all_gather(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None,
                    wire: Optional[str] = None, reverse: bool = False,
                    groups=None) -> torch.Tensor:
    """Ring all-gather: rank i contributes chunk ``x`` (length m) and all
    ranks end with the concatenation [size*m] in ring order
    (TryAllgatherRing, allreduce_base.cc:751-815).

    With ``wire``, each chunk is encoded ONCE by its owner and the encoded
    bytes are forwarded verbatim hop to hop (the owner keeps the decode
    of its own encoding), so all ranks end bit-identical. ``reverse``
    gathers around the counter-rotating ring; ``groups`` gathers over
    every sub-ring at once (each rank ends with its own group's chunks in
    group order)."""
    ring, pos = _my_ring(group, groups)
    size = len(ring)
    if size == 1:
        return x
    wire = _normalize_wire(wire, SUM, x.dtype, x.shape[0])
    _, ag_codec, block = _parse_wire(wire) if wire else (None, None, 0)
    y, back = _as_reducible(x.contiguous(), SUM)
    lane = _Lane(torch.empty((size,) + tuple(y.shape), dtype=y.dtype,
                             device=y.device), ring, pos, reverse)
    own, enc = _ag_start(y, ag_codec, block)
    lane.buf[pos] = own
    _ag_lanes([lane], group, ag_codec, [enc])
    return back(lane.buf.reshape((size * y.shape[0],) + tuple(y.shape[1:])))


@_annotated("ring")
def ring_allreduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                   op: int = SUM, wire: Optional[str] = None,
                   reverse: bool = False, groups=None) -> torch.Tensor:
    """Ring allreduce = reduce-scatter + all-gather (TryAllreduceRing,
    allreduce_base.cc:930-949). A length not divisible by the ring size
    (times the int8 block, under an int8 wire) is padded with zeros, which
    are sliced off again (for MAX/MIN the padding is reduced but never
    returned). ``wire``, ``reverse`` and ``groups`` as in
    :func:`ring_reduce_scatter`; every rank ends bit-identical."""
    _check_flat(x, "ring_allreduce", op)
    ring, pos = _my_ring(group, groups)
    if len(ring) == 1:
        return x
    wire = _normalize_wire(wire, op, x.dtype)  # eligibility; pad below
    y, back = _as_reducible(x.contiguous(), op)
    yp, n = _pad_to_multiple(y, _wire_pad_mult(wire, len(ring)))
    out, = _ring_allreduce_lanes([yp], ring, pos, [reverse], group, op, wire)
    return back(out[:n])


@_annotated("bidir")
def bidir_ring_allreduce(x: torch.Tensor,
                         group: Optional[dist.ProcessGroup] = None,
                         op: int = SUM, wire: Optional[str] = None,
                         groups=None) -> torch.Tensor:
    """Bidirectional ring allreduce: the payload splits in half and the
    halves run counter-rotating rings, each step's four transfers posted
    as one batch, so both directions of every link carry data (n/2p a hop
    each way instead of n/p one way). Same contract as
    :func:`ring_allreduce`; the halves follow the JAX package's
    ``ring_allreduce`` and ``ring_allreduce(reverse=True)``, so the bits
    are theirs. Payloads too small to split (< 2p elements) run a single
    forward ring."""
    _check_flat(x, "bidir_ring_allreduce", op)
    p, n = dist.get_world_size(group), x.shape[0]
    if p == 1:
        return x
    if n < 2 * p:
        return ring_allreduce(x, group, op, wire=wire, groups=groups)
    ring, pos = _my_ring(group, groups)
    if len(ring) == 1:
        return x
    wire = _normalize_wire(wire, op, x.dtype)
    y, back = _as_reducible(x.contiguous(), op)
    half = n - n // 2
    mult = _wire_pad_mult(wire, len(ring))
    (lo, nlo), (hi, nhi) = (_pad_to_multiple(y[:half], mult),
                            _pad_to_multiple(y[half:], mult))
    lo, hi = _ring_allreduce_lanes([lo, hi], ring, pos, [False, True],
                                   group, op, wire)
    return back(torch.cat([lo[:nlo], hi[:nhi]]))


@functools.lru_cache(maxsize=None)
def _swing_tables(p: int):
    """Static Swing schedule for a power-of-two world (arXiv:2401.09356);
    the JAX package's tables, with their asserts.

    Peer of rank i at step s is ``(i ± rho(s)) mod p`` (+ for even ranks,
    − for odd) with ``rho(s) = (1-(-2)^(s+1))/3`` -- the 1,-1,3,-5,11,...
    distance sequence. Returns ``(peers, send_idx, recv_idx)``:
    ``peers[s]`` is the length-p partner table (an involution, asserted);
    ``send_idx[s]`` / ``recv_idx[s]`` are ``[p, 2^(k-1-s)]`` int arrays of
    the chunk indices rank i ships / keeps at reduce-scatter step s, built
    backward from the final ownership (rank i ends owning chunk i) via
    ``resp[s-1][i] = resp[s][i] ∪ resp[s][peer]``. The all-gather runs the
    same tables in reverse."""
    if p < 2 or p & (p - 1):
        raise ValueError(f"swing needs a power-of-two world, got {p}")
    k = p.bit_length() - 1
    peers = []
    for s in range(k):
        d = (1 - (-2) ** (s + 1)) // 3
        row = [(i + d) % p if i % 2 == 0 else (i - d) % p
               for i in range(p)]
        assert all(row[row[i]] == i for i in range(p)), (p, s, row)
        peers.append(row)
    resp = [None] * k
    resp[k - 1] = [frozenset((i,)) for i in range(p)]
    for s in range(k - 1, 0, -1):
        resp[s - 1] = [resp[s][i] | resp[s][peers[s][i]] for i in range(p)]
    for s in range(k):
        for i in range(p):
            assert len(resp[s][i]) == 1 << (k - 1 - s), (p, s, i)
            assert not (resp[s][i] & resp[s][peers[s][i]]), (p, s, i)
    for i in range(p):
        assert len(resp[0][i] | resp[0][peers[0][i]]) == p, (p, i)
    send_idx = [np.array([sorted(resp[s][peers[s][i]]) for i in range(p)],
                         dtype=np.int32) for s in range(k)]
    recv_idx = [np.array([sorted(resp[s][i]) for i in range(p)],
                         dtype=np.int32) for s in range(k)]
    return peers, send_idx, recv_idx


@functools.lru_cache(maxsize=None)
def _swing_rows(size: int, pos: int, device: torch.device):
    """Rank ``pos``'s (send rows, keep rows) of each step, as index
    tensors on ``device`` (made once, not each call)."""
    _, send_idx, recv_idx = _swing_tables(size)
    return tuple((torch.as_tensor(s[pos], dtype=torch.long, device=device),
                  torch.as_tensor(r[pos], dtype=torch.long, device=device))
                 for s, r in zip(send_idx, recv_idx))


@_annotated("swing")
def swing_allreduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                    op: int = SUM, wire: Optional[str] = None,
                    groups=None) -> torch.Tensor:
    """Swing allreduce (arXiv:2401.09356): recursive distance-halving
    reduce-scatter + the mirrored all-gather, 2·log2(p) exchanges against
    the ring's 2(p-1). A world (or group size) that is not a power of two
    runs :func:`ring_allreduce` instead, as in the JAX package (same
    result, another schedule). Same contract as :func:`ring_allreduce`:
    1-D input, ``wire`` on float SUM, each chunk's all-gather encoding
    forwarded verbatim; ``groups`` runs it over every sub-ring at once."""
    _check_flat(x, "swing_allreduce", op)
    ring, pos = _my_ring(group, groups)
    size = len(ring)
    if size == 1:
        return x
    if size & (size - 1) or x.shape[0] == 0:
        return ring_allreduce(x, group, op, wire=wire, groups=groups)
    wire = _normalize_wire(wire, op, x.dtype)  # eligibility; pad below
    rs_codec, ag_codec, block = (_parse_wire(wire) if wire
                                 else (None, None, 0))
    y, back = _as_reducible(x.contiguous(), op)
    yp, n = _pad_to_multiple(y, _wire_pad_mult(wire, size))
    peers = _swing_tables(size)[0]
    rows = _swing_rows(size, pos, yp.device)
    combine = torch_reduce_fn(op)
    acc = torch.float32 if rs_codec else yp.dtype
    chunks = yp.reshape(size, -1).to(acc, copy=True)
    m = chunks.shape[1]

    # Reduce-scatter: at step s exchange with peers[s], shipping the
    # accumulated chunks the peer is responsible for and folding the
    # received ones into ours. The peer ships its rows sorted by chunk
    # index -- the order of our keep rows -- so they align as they come.
    for s, (send_rows, keep_rows) in enumerate(rows):
        peer = ring[peers[s][pos]]
        send = chunks.index_select(0, send_rows)
        if rs_codec is None:
            got, = _exchange([send], peer, peer, group)
        else:
            got = _decode(_exchange(list(_encode(send, rs_codec, block)),
                                    peer, peer, group), rs_codec, send.shape)
        chunks.index_copy_(0, keep_rows, combine(
            chunks.index_select(0, keep_rows), got))
    mine = chunks[pos].to(yp.dtype)

    # All-gather: the same tables backward -- at step s each rank ships
    # its complete responsibility set and receives the peer's. With a
    # codec each chunk is encoded once by its owner and its bytes travel
    # verbatim (the store holds encodings, decoded once at the end).
    enc0 = (mine,) if ag_codec is None else _encode(mine, ag_codec, block)
    store = []
    for e in enc0:
        st = e.new_zeros((size,) + tuple(e.shape))
        st[pos] = e
        store.append(st)
    for s in range(len(rows) - 1, -1, -1):
        send_rows, keep_rows = rows[s]
        peer = ring[peers[s][pos]]
        got = _exchange([st.index_select(0, keep_rows) for st in store],
                        peer, peer, group)
        for st, g in zip(store, got):
            st.index_copy_(0, send_rows, g)
    out = store[0] if ag_codec is None else _decode(
        store, ag_codec, (size, m)).to(mine.dtype)
    return back(out.reshape(size * m)[:n])


@_annotated("hier")
def hier_allreduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                   op: int = SUM, groups=None, wire: Optional[str] = None,
                   inter_method: str = "ring",
                   phase_guard=None) -> torch.Tensor:
    """Two-level hierarchical allreduce over host groups:

    1. intra-group reduce-scatter (the grouped ring; the JAX package uses
       XLA's native grouped reduce-scatter for SUM, which for groups of
       two adds the same two numbers; never wire-quantized);
    2. inter-group ring (or swing) allreduce of the reduced shards over
       the slot rings (rank j of every group forms ring j); ``wire``
       applies here, the only phase on the slow links;
    3. intra-group all-gather of the finished shards.

    Degenerate worlds short-circuit as in the JAX package: unknown
    topology, one rank a group or ragged groups run the flat
    ``inter_method`` schedule; a single group runs one flat unquantized
    ring. All ranks end bit-identical. ``phase_guard(name, nbytes)``, where
    given, wraps each of the three phases (a watchdog's per-phase guard,
    as ``device_hier_allreduce`` takes it); the flat degradations run
    unguarded."""
    _check_flat(x, "hier_allreduce", op)
    if inter_method not in ("ring", "swing"):
        raise ValueError(
            f"inter_method must be 'ring' or 'swing', got {inter_method!r}")
    p = dist.get_world_size(group)
    if p == 1:
        return x
    flat_fn = swing_allreduce if inter_method == "swing" else ring_allreduce
    if not groups or not _topology.is_hierarchical(groups, p):
        if groups and len(groups) == 1:
            return ring_allreduce(x, group, op, wire=None)
        return flat_fn(x, group, op, wire=wire)
    wire = _normalize_wire(wire, op, x.dtype)  # eligibility; pad below
    y, back = _as_reducible(x.contiguous(), op)
    run_phase = _labelled_phase
    if phase_guard is not None:
        def run_phase(ph: _Phase, fn):
            with phase_guard(ph.name, ph.nbytes):
                return _labelled_phase(ph, fn)
    return back(_hier_phases(y, group, op, groups, wire, inter_method,
                             run_phase))


@dataclass(frozen=True)
class _Phase:
    """One phase of the hierarchical schedule, as the JAX package's
    ``device_hier_allreduce`` describes it to its span, its cost model and
    its guard: ``name`` (``hier.reduce_scatter``, ``hier.inter``,
    ``hier.allgather``), the ``phase`` attribute, the payload bytes, the
    phase's method and wire, and the cost model's element count, world and
    direction."""
    name: str
    phase: str
    nbytes: int
    method: str
    wire: Optional[str]
    cost_n: int
    cost_axis: int
    cost_phase: Optional[str]


def _labelled_phase(ph: _Phase, fn: Callable[[], torch.Tensor]
                    ) -> torch.Tensor:
    """A phase under JAX's ``rabit_hier_*`` label (``collectives.py:682-
    691``) when telemetry is on; the schedule's own phases run so."""
    if not telemetry.enabled():
        return fn()
    with telemetry.trace_annotation("rabit_" + ph.name.replace(".", "_")):
        return fn()


def _hier_phases(y: torch.Tensor, group, op: int, groups, wire,
                 inter_method: str, run_phase) -> torch.Tensor:
    """The three phases of the hierarchical schedule over a two-level
    ``groups`` (``y`` flat, in a reducible dtype, ``wire`` normalized),
    each through ``run_phase(phase, fn)`` (a :class:`_Phase` and the call
    that runs it)."""
    p = dist.get_world_size(group)
    groups = tuple(tuple(int(r) for r in grp) for grp in groups)
    g, _ = _group_tables(groups, p)
    hosts = len(groups)
    slots = _topology.slot_rings(groups)
    flat_fn = swing_allreduce if inter_method == "swing" else ring_allreduce
    # pad so the intra shard (n/g) splits evenly into inter chunks (n/p);
    # the int8 block constraint lands on the inter phase's chunk
    yp, n = _pad_to_multiple(y, _wire_pad_mult(wire, p))
    isz = y.element_size()
    n_pad = yp.shape[0]
    mine = run_phase(
        _Phase("hier.reduce_scatter", "reduce_scatter", n * isz, "ring",
               None, n, g, "rs"),
        lambda: ring_reduce_scatter(yp, group, op, groups=groups))
    mine = run_phase(
        _Phase("hier.inter", "inter", n_pad // g * isz, inter_method, wire,
               n_pad // g, hosts, None),
        lambda: flat_fn(mine, group, op, wire=wire, groups=slots))
    full = run_phase(
        _Phase("hier.allgather", "allgather", n * isz, "ring", None, n_pad,
               g, "ag"),
        lambda: ring_all_gather(mine, group, groups=groups))
    return full[:n]


@_annotated("preagg")
def preagg_allreduce(x: torch.Tensor,
                     group: Optional[dist.ProcessGroup] = None,
                     op: int = SUM, groups=None) -> torch.Tensor:
    """Pre-aggregating allreduce for a world with a known laggard
    (arXiv:1804.05349), ``groups = ((early...), (laggard,))``:

    1. the early ranks reduce among themselves (a ring over ``early``;
       the JAX package's grouped psum); the laggard exchanges nothing;
    2. one exchange at the fold root ``early[0]``: the laggard's raw
       vector goes out, the early result comes back;
    3. the laggard's vector doubles binomially to the remaining ranks and
       every rank folds locally: ``combine(early result, laggard's x)``.

    SUM/MAX/MIN only; the wire codec never applies. All ranks end
    bit-identical: each value is produced once and copied."""
    _check_flat(x, "preagg_allreduce", op)
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    if p == 1:
        return x
    if (not groups or len(groups) != 2 or len(groups[1]) != 1
            or sorted(tuple(groups[0]) + tuple(groups[1]))
            != list(range(p))):
        raise ValueError(
            f"preagg groups must be ((early...), (laggard,)) covering "
            f"ranks 0..{p - 1}, got {groups!r}")
    if op not in (SUM, MAX, MIN):
        raise ValueError(
            f"preagg_allreduce supports SUM/MAX/MIN, got op {op}")
    early, laggard = tuple(int(r) for r in groups[0]), int(groups[1][0])
    root = early[0]
    combine = torch_reduce_fn(op)
    y, back = _as_reducible(x.contiguous(), op)
    # phase 1: the early ranks' reduction
    partial = y
    if idx in early and len(early) > 1:
        yp, n = _pad_to_multiple(y, len(early))
        out, = _ring_allreduce_lanes([yp], early, early.index(idx), [False],
                                     group, op, None)
        partial = out[:n]
    # phase 2: the full-duplex exchange at the fold root
    sub, lag_vec = partial, torch.zeros_like(y)
    if idx in (root, laggard):
        other = laggard if idx == root else root
        recv, = _exchange([partial], other, other, group)
        sub = recv if idx == laggard else partial
        lag_vec = recv if idx == root else partial
    # phase 3: binomial doubling of the laggard's vector
    holders, others = [laggard, root], list(early[1:])
    while others:
        pairs = list(zip(holders, others))
        to = next((d for s, d in pairs if s == idx), None)
        frm = next((s for s, d in pairs if d == idx), None)
        got = [torch.empty_like(lag_vec)]
        _post([([lag_vec], got, to, frm)], group)
        if frm is not None:
            lag_vec = got[0]
        holders += [d for _, d in pairs]
        others = others[len(pairs):]
    return back(combine(sub, lag_vec))


# method name -> allreduce over a flat 1-D tensor
_METHOD_FNS = {
    "ring": ring_allreduce,
    "bidir": bidir_ring_allreduce,
    "swing": swing_allreduce,
}


def _per_shard_allreduce(flat: torch.Tensor, group, op: int, method: str,
                         wire: Optional[str], groups=None) -> torch.Tensor:
    if method == "tree":
        return tree_allreduce(flat, group, op)
    if method == "hier":
        return hier_allreduce(flat, group, op, groups=groups, wire=wire)
    if method == "preagg":
        return preagg_allreduce(flat, group, op, groups=groups)
    return _METHOD_FNS[method](flat, group, op, wire=wire, groups=groups)


# ---------------------------------------------------------------------------
# The skew plane's hooks (``telemetry/skew.py``): the agreement boundary and
# the plans that only it may steer. With ``rabit_skew_adapt`` unset none of
# them runs: no broadcast, no host synchronisation, no counter advance.
# ---------------------------------------------------------------------------

def _skew_sync_point(group, device: torch.device) -> None:
    """The fleet agreement boundary of skew adaptation (JAX
    ``_skew_sync_point``). Every rank must run the same schedule for the
    same round, so ranks may only act on a digest they all hold: at
    deterministic dispatch counts (``skew.sync_due``; program order is the
    rendezvous, the same on every rank) group rank 0 broadcasts its
    candidate as the fixed-shape float vector of ``skew.encode_digest``
    and every rank adopts the decoded result (``SkewMonitor.applied``);
    only that digest reaches ``adapt_plan`` or dispatch. A world of one
    process adopts its own candidate and broadcasts nothing. A proper
    sub-group (a dp or sp group of a mesh) adopts None, as the JAX
    package's multi-axis meshes do: each sub-group's rank 0 would
    broadcast its own candidate, and the groups could adopt different
    ones.

    The vector travels on ``device`` over NCCL (it must be a CUDA device:
    a CPU tensor there raises rather than skip the broadcast) and on the
    CPU over gloo; reading the result back is the one host
    synchronisation a boundary costs."""
    if not _skew.sync_due():
        return
    mon = _skew.monitor()
    if dist.get_world_size() == 1:
        mon.set_applied(mon.current())
        return
    if not _whole_world(group):
        mon.set_applied(None)
        return
    p = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        if device.type != "cuda":
            raise RuntimeError(
                "skew agreement over an NCCL group needs a CUDA tensor, "
                f"got one on {device}; pass the payload on the card")
        at = device
    else:
        at = torch.device("cpu")
    vec = torch.tensor(_skew.encode_digest(mon.current(), p),
                       dtype=torch.float32, device=at)
    g = group if group is not None else dist.group.WORLD
    dist.broadcast(vec, src=dist.get_global_rank(g, 0), group=group)
    mon.set_applied(_skew.decode_digest(vec.cpu().tolist()))
    telemetry.count("dispatch.skew_sync")


def _whole_world(group) -> bool:
    """Whether ``group`` holds every process of the world. The agreed
    digest names its laggard and root by global rank, and only in such a
    group is that the rank a plan permutes (``new_group`` orders its
    ranks by global rank)."""
    return dist.get_world_size(group) == dist.get_world_size()


def _agreed_digest(group):
    """The fleet-agreed digest that may steer a call over ``group``:
    None on a proper sub-group, which plans nothing."""
    return _skew.monitor().applied() if _whole_world(group) else None


def _rotation_for(group, device: torch.device, world: int):
    """Skew adaptation for the reduce-scatter and all-gather primitives:
    ``(order, adapted)``. Rotation is the only plan they admit (no tree to
    re-root, nothing to pre-aggregate), so this reads the fleet-agreed
    digest directly: a laggard inside this world walks the ring in
    laggard-last order; anything else gives ``(None, None)``, the flat
    ring."""
    if not _skew.adapt_enabled() or world < 2:
        return None, None
    _skew_sync_point(group, device)
    lag = _skew.laggard_of(_agreed_digest(group))
    if lag is None or not 0 <= lag < world:
        _skew.note_applied(None)
        return None, None
    adapted = f"rotate@{lag}"
    _skew.note_applied(adapted)
    telemetry.count("dispatch.skew_adapted")
    return _skew.rotation_order(world, lag), adapted


def _skew_hier(x: torch.Tensor, group, op: int, groups):
    """Skew adaptation of a two-level hierarchical allreduce: ``(groups,
    adapted)``, the lagging delegate demoted to the tail of its host group
    (``skew.demote_delegate``) when the agreed digest names one. A
    grouping that is not two-level, or the knob off, passes through."""
    p = dist.get_world_size(group)
    if not _skew.adapt_enabled() or not groups \
            or not _topology.is_hierarchical(groups, p):
        return groups, None
    _skew_sync_point(group, x.device)
    plan = _skew.adapt_plan("hier", p, x.numel() * x.element_size(),
                            OP_NAMES.get(op, str(op)), groups=groups,
                            digest=_agreed_digest(group))
    adapted = None
    if plan is not None:
        groups = plan["groups"]
        adapted = f"{plan['kind']}@{plan['laggard']}"
    _skew.note_applied(adapted)
    return groups, adapted


def allreduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
              op: int = SUM, method: str = "auto",
              wire: Optional[str] = "auto", groups=None) -> torch.Tensor:
    """Allreduce this rank's ``x`` (any shape) over ``group``; the port of
    ``device_allreduce``, under its ``allreduce`` span and cost stamp.

    With ``rabit_skew_adapt`` on, the call first passes the skew
    agreement boundary (:func:`_skew_sync_point`), then applies the plan
    of ``skew.adapt_plan`` for the fleet-agreed digest: the ring family
    rotated laggard-last, the tree re-rooted, hier with its lagging
    delegate demoted, or pre-aggregation (which drops the wire); the span
    carries ``adapted="<kind>@<laggard>"``. Every plan only permutes the
    schedule, so integer-valued payloads give the flat run's bits.

    ``method="auto"`` picks among {tree, ring, bidir, swing, hier} per
    payload size from the port's measured dispatch table
    (``parallel/dispatch.py``); without a table: tree below 32768
    elements, ring above, and the ring for large BITOR. ``wire``: "auto"
    engages a config/env-requested wire (``rabit_dataplane_wire``) only
    where the table or ``rabit_dataplane_wire_mincount`` says it pays;
    an explicit spec forces it; None/"none" turn it off. ``groups``: the
    host grouping for ``hier`` (and the laggard split for ``preagg``),
    else the ``RABIT_HIER_GROUP`` override (``parallel/topology.py``);
    flat methods drop it."""
    plan = _allreduce_plan(x, group, op, method, wire, groups)
    sp = telemetry.span("allreduce", nbytes=plan.nbytes, op=plan.opname,
                        method=plan.method, wire=plan.wire, **plan.extra)
    with sp:
        t0 = time.perf_counter()
        out = plan.run()
        _finish(sp, out, t0)
    return out


@dataclass
class _Plan:
    """``allreduce``'s resolution: the schedule it chose, the call that
    runs it, and what its span and cost stamp say."""
    run: Callable[[], torch.Tensor]
    method: str
    wire: Optional[str]
    opname: str
    nbytes: int
    extra: dict           # cost_* attributes (profiling on), hosts (hier),
    #                       adapted (a skew plan)


def _allreduce_plan(x: torch.Tensor, group, op: int, method: str, wire,
                    groups) -> _Plan:
    """``allreduce``'s resolution (the skew boundary, grouping, method
    and wire, then the skew plan) and its analytic cost, recorded when
    profiling is on."""
    p = dist.get_world_size(group)
    if _skew.adapt_enabled():
        # BEFORE resolve: dispatch's method-family election reads the
        # agreed digest too, so it must be current at this boundary
        _skew_sync_point(group, x.device)
    groups = _topology.resolve_groups(p, explicit=groups)
    n = x.numel()
    method, wire = _dispatch.resolve(n, x.dtype, op, p, method=method,
                                     wire=wire, groups=groups,
                                     skew=_whole_world(group))
    if method not in ("hier", "preagg"):
        groups = None
    adapted = None
    if _skew.adapt_enabled():
        # only the fleet-AGREED digest steers the plan: a per-process
        # candidate would run different schedules on different ranks
        plan = _skew.adapt_plan(method, p, n * x.element_size(),
                                OP_NAMES.get(op, str(op)), groups=groups,
                                digest=_agreed_digest(group))
        if plan is not None:
            method, groups = plan["method"], plan["groups"]
            if method == "preagg":
                wire = None  # raw exchanges: the codec never applies
            adapted = f"{plan['kind']}@{plan['laggard']}"
        _skew.note_applied(adapted)
    extra = _cost_attrs(_profile.record_cost(
        "allreduce", method, wire, n, x.element_size(), p,
        group_size=len(groups[0]) if groups else None))
    if method == "hier" and groups:
        extra["hosts"] = len(groups)
    if adapted:
        extra["adapted"] = adapted

    def run() -> torch.Tensor:
        return _per_shard_allreduce(x.reshape(-1), group, op, method, wire,
                                    groups).reshape(x.shape)
    return _Plan(run, method, wire, OP_NAMES.get(op, str(op)),
                 n * x.element_size(), extra)


def allreduce_numpy(buf: np.ndarray, group: Optional[dist.ProcessGroup],
                    op: int, device: torch.device, method: str = "auto",
                    wire: Optional[str] = "auto", groups=None,
                    phase_guard=None) -> None:
    """Allreduce the host buffer ``buf`` in place through ``device``: the
    reference's in-place ``sendrecvbuf`` contract (engine.h:74-96), shared
    by ``TorchEngine`` and the robust engine's ``TorchDataPlane``. The
    buffer is staged onto the device and reduced by the dispatcher
    (``allreduce``), or for ``method="hier"`` by ``hier_allreduce`` over
    ``groups`` with that function's own degradation (one group: a flat
    ring without the wire; one rank a group or ragged groups: a flat ring
    with it), where the dispatcher turns an explicit ``hier`` on such a
    world into a ring that keeps the wire; the result is copied back.
    ``phase_guard`` goes to ``hier_allreduce`` (``TorchEngine``'s
    per-phase watchdog guards)."""
    x = tensor_from_numpy(buf).to(device)
    if method == "hier":
        groups, _ = _skew_hier(x, group, op, groups)
        out = hier_allreduce(x.reshape(-1), group, op, groups=groups,
                             wire=wire, phase_guard=phase_guard)
    else:
        out = allreduce(x, group, op, method=method, wire=wire)
    np.copyto(buf, numpy_from_tensor(out.reshape(x.shape), buf.dtype))


def bcast_from_root(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None,
                    root: int = 0) -> torch.Tensor:
    """Every rank gets rank ``root``'s ``x`` (TryBroadcast,
    allreduce_base.cc:649-737). ``root`` is a rank of ``group``."""
    g = group if group is not None else dist.group.WORLD
    y, back = _as_reducible(x.contiguous(), SUM)
    y = y.clone()
    dist.broadcast(y, src=dist.get_global_rank(g, root), group=group)
    return back(y)


def shard_over(xs: np.ndarray, rank: int,
               device: torch.device) -> torch.Tensor:
    """Row ``rank`` of a host array [p, ...] as this rank's tensor on
    ``device`` — the 'each rank contributes a slice' layout (what
    ``shard_over`` places across a mesh in the JAX package)."""
    if not 0 <= rank < xs.shape[0]:
        raise ValueError(f"rank {rank} out of range for {xs.shape[0]} rows")
    return tensor_from_numpy(xs[rank]).to(device)


# ---------------------------------------------------------------------------
# The device entry points of the JAX package (``device_reduce_scatter`` ...
# ``device_broadcast``): each rank passes its own tensor and the group
# where JAX takes a global [p, ...] array over a mesh axis, and gets back
# what that rank holds in JAX's output sharding. Where the JAX entry point
# reads the skew plan, so does the port's (``_rotation_for``, ``_skew_hier``,
# ``_allreduce_plan``).
# ---------------------------------------------------------------------------

def device_reduce_scatter(x: torch.Tensor,
                          group: Optional[dist.ProcessGroup] = None,
                          op: int = SUM, wire: Optional[str] = None
                          ) -> torch.Tensor:
    """Reduce-scatter of this rank's ``x`` (n elements, any shape) over
    ``group``: rank i gets chunk i of the elementwise reduction, n/p
    elements starting at i*n/p, flat (the layout
    :func:`device_allgather` inverts). n must divide by p: the caller
    owns the chunk layout (:func:`allreduce` pads and slices). ``wire``
    as in :func:`ring_reduce_scatter`; ``"auto"`` asks
    ``dispatch.resolve``. Under skew adaptation the ring walks in
    laggard-last order (:func:`_rotation_for`): the input's chunks are
    permuted by the same order, so rank i still owns chunk i."""
    p, n = dist.get_world_size(group), x.numel()
    if n % p:
        raise ValueError(
            f"reduce_scatter payload of {n} elements must divide by the "
            f"axis size {p} (rank i owns chunk i of length n/p); pad the "
            "input or use allreduce")
    if wire == "auto":
        _, wire = _dispatch.resolve(n, x.dtype, op, p, method="ring",
                                    wire="auto")
    wire = _normalize_wire(_canonical_wire(wire), op, x.dtype, n // p)
    order, adapted = _rotation_for(group, x.device, p)
    isz = x.element_size()
    extra = _cost_attrs(_profile.record_cost("reduce_scatter", "ring", wire,
                                             n, isz, p, phase="rs"))
    if adapted:
        extra["adapted"] = adapted
    sp = telemetry.span("reduce_scatter", nbytes=n * isz,
                        op=OP_NAMES.get(op, str(op)), method="ring",
                        wire=wire, **extra)
    with sp:
        t0 = time.perf_counter()
        with telemetry.trace_annotation("rabit_reduce_scatter"):
            flat = x.reshape(-1)
            if order is None:
                out = ring_reduce_scatter(flat, group, op, wire=wire)
            else:
                # the grouped ring lands ownership on the ring position,
                # so the chunks enter in ring order: rank order[j] owns
                # chunk order[j] of the original layout
                rot = flat.reshape(p, -1)[list(order)].reshape(-1)
                out = ring_reduce_scatter(rot, group, op, wire=wire,
                                          groups=(order,))
        _finish(sp, out, t0)
    return out


def device_allgather(x: torch.Tensor,
                     group: Optional[dist.ProcessGroup] = None,
                     wire: Optional[str] = None) -> torch.Tensor:
    """All-gather of this rank's ``x`` (m elements, flattened): every rank
    gets the p*m rank-order concatenation. ``wire`` as in
    :func:`ring_all_gather`; ``"auto"`` asks ``dispatch.resolve``. Under
    skew adaptation the ring walks in laggard-last order and the result
    is put back into rank order."""
    p, m = dist.get_world_size(group), x.numel()
    if wire == "auto":
        _, wire = _dispatch.resolve(p * m, x.dtype, SUM, p, method="ring",
                                    wire="auto")
    wire = _normalize_wire(_canonical_wire(wire), SUM, x.dtype, m)
    order, adapted = _rotation_for(group, x.device, p)
    isz = x.element_size()
    extra = _cost_attrs(_profile.record_cost("allgather", "ring", wire,
                                             p * m, isz, p, phase="ag"))
    if adapted:
        extra["adapted"] = adapted
    sp = telemetry.span("allgather", nbytes=p * m * isz, method="ring",
                        wire=wire, **extra)
    with sp:
        t0 = time.perf_counter()
        with telemetry.trace_annotation("rabit_allgather"):
            out = ring_all_gather(x.reshape(-1), group, wire=wire,
                                  groups=None if order is None
                                  else (order,))
            if order is not None:
                # the grouped gather concatenates in ring order: chunk j
                # is rank order[j]'s, back to rank order
                inv = [0] * p
                for j, r in enumerate(order):
                    inv[r] = j
                out = out.reshape(p, -1)[inv].reshape(-1)
        _finish(sp, out, t0)
    return out


def _hier_setup(x: torch.Tensor, group, op: int, groups, wire,
                inter_method: str):
    """``device_hier_allreduce``'s set-up: ``(groups, wire, adapted)``,
    the two-level grouping (its lagging delegate demoted under skew
    adaptation, :func:`_skew_hier`), the inter phase's normalized wire and
    the skew plan's tag; or, where the grouping is not two-level, ``(None,
    wire, None)`` for the flat ``inter_method`` call it degrades to (JAX's
    rules: a single group drops the wire, every link being local)."""
    if inter_method not in ("ring", "swing"):
        raise ValueError(
            f"inter_method must be 'ring' or 'swing', got {inter_method!r}")
    p = dist.get_world_size(group)
    groups = _topology.resolve_groups(p, explicit=groups)
    if not _topology.is_hierarchical(groups, p):
        if groups and len(groups) == 1:
            wire = None
        return None, wire or "none", None
    groups, adapted = _skew_hier(x, group, op, groups)
    if wire == "auto":
        _, wire = _dispatch.resolve(x.numel() // len(groups[0]), x.dtype, op,
                                    len(groups), method="ring", wire="auto")
    return (groups, _normalize_wire(_canonical_wire(wire), op, x.dtype),
            adapted)


def _hier_run(x: torch.Tensor, group, op: int, groups, wire,
              inter_method: str, run_phase) -> torch.Tensor:
    y, back = _as_reducible(x.reshape(-1).contiguous(), op)
    return back(_hier_phases(y, group, op, groups, wire, inter_method,
                             run_phase)).reshape(x.shape)


def _phase_cost(ph: _Phase, itemsize: int, g: int) -> dict:
    return _cost_attrs(_profile.record_cost(
        ph.name, ph.method, ph.wire, ph.cost_n, itemsize, ph.cost_axis,
        phase=ph.cost_phase, group_size=g))


def device_hier_allreduce(x: torch.Tensor,
                          group: Optional[dist.ProcessGroup] = None,
                          op: int = SUM, groups=None,
                          wire: Optional[str] = None,
                          inter_method: str = "ring",
                          phase_guard=None) -> torch.Tensor:
    """The hierarchical allreduce as three phases the host sees apart:
    intra-group reduce-scatter, inter-group ``inter_method`` over the slot
    rings (``wire`` applies there only), intra-group all-gather, each run
    inside ``phase_guard(phase, nbytes)`` (a factory of context managers,
    JAX's phase names ``hier.reduce_scatter``, ``hier.inter`` and
    ``hier.allgather``; by default none). Each phase has its own span under
    its name, the three sharing one ``round`` and carrying ``phase``,
    ``hosts``, ``group_size`` and the phase's cost. ``groups``: explicit,
    else the ``RABIT_HIER_GROUP`` grouping. A grouping that is not
    two-level runs the flat ``inter_method`` through :func:`allreduce` (one
    group: without the wire), unguarded, as in the JAX package. Under skew
    adaptation a lagging delegate is demoted to the tail of its group and
    each phase's span carries ``adapted``."""
    groups, wire, adapted = _hier_setup(x, group, op, groups, wire,
                                        inter_method)
    if groups is None:
        return allreduce(x, group, op, method=inter_method, wire=wire)
    guard = phase_guard or (lambda name, nbytes: contextlib.nullcontext())
    rnd = telemetry.collective_round("hier_allreduce")
    opname, isz = OP_NAMES.get(op, str(op)), x.element_size()
    g, hosts = len(groups[0]), len(groups)

    def run_phase(ph: _Phase, fn):
        cost = _phase_cost(ph, isz, g)
        if adapted:
            cost["adapted"] = adapted
        sp = telemetry.span(ph.name, nbytes=ph.nbytes, op=opname,
                            method=ph.method, wire=ph.wire, round=rnd,
                            phase=ph.phase, hosts=hosts, group_size=g,
                            **cost)
        with guard(ph.name, ph.nbytes), sp:
            t0 = time.perf_counter()
            out = _labelled_phase(ph, fn)
            _finish(sp, out, t0)
        return out
    return _hier_run(x, group, op, groups, wire, inter_method, run_phase)


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten``'s order,
    and the function that rebuilds the tree from new leaves: a mapping by
    its sorted keys (not insertion order, and not
    ``nn.Module.parameters()`` order: the order sets the buckets' chunk
    boundaries, and so the bits), a list or tuple as it is, a tensor as
    one leaf."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda out: out[0]
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda out: dict(zip(keys, out))
    if isinstance(tree, (list, tuple)):
        return list(tree), type(tree)
    raise TypeError(f"a tree is a tensor, or a mapping or a sequence of "
                    f"tensors, got {type(tree).__name__}")


def _by_dtype(leaves: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    """Leaf indices bucketed one buffer per dtype, in first-seen order."""
    buckets: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        buckets.setdefault(leaf.dtype, []).append(i)
    return buckets


def _concat(leaves: Sequence[torch.Tensor], idxs) -> torch.Tensor:
    return torch.cat([leaves[i].reshape(-1) for i in idxs])


def _split(red: torch.Tensor, leaves: Sequence[torch.Tensor], idxs
           ) -> List[torch.Tensor]:
    """A reduced bucket cut back into its leaves' shapes (views)."""
    out, off = [], 0
    for i in idxs:
        n = leaves[i].numel()
        out.append(red[off:off + n].reshape(leaves[i].shape))
        off += n
    return out


def _bucketed(leaves: Sequence[torch.Tensor], group, op: int,
              plan: Callable[[torch.dtype, int], Tuple[str, Optional[str]]]
              ) -> List[torch.Tensor]:
    """Each dtype's bucket of ``leaves`` through one allreduce, its
    ``(method, wire)`` from ``plan(dtype, element count)`` (every bucket
    planned before the first runs), cut back into the leaves."""
    buckets = _by_dtype(leaves)
    plans = {dt: plan(dt, sum(leaves[i].numel() for i in idxs))
             for dt, idxs in buckets.items()}
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for dt, idxs in buckets.items():
        red = _per_shard_allreduce(_concat(leaves, idxs), group, op,
                                   *plans[dt])
        for i, part in zip(idxs, _split(red, leaves, idxs)):
            out[i] = part
    return out


def bucket_allreduce(tree, group: Optional[dist.ProcessGroup] = None,
                     op: int = SUM, wire: Optional[str] = None,
                     method: str = "ring", presum_group=None):
    """DDP-style bucketed allreduce of this rank's tree (a mapping or a
    sequence of tensors): the leaves, in JAX's flatten order, are
    concatenated into one buffer per dtype, each buffer runs one
    ``method`` allreduce over ``group``, and the results are cut back into
    the tree. ``presum_group`` first sums every leaf over that group (the
    transformer's sequence-parallel partials). ``method`` is one schedule
    ("tree", "ring", "bidir", "swing"); :func:`device_allreduce_tree`
    resolves it per bucket."""
    if method != "tree" and method not in _METHOD_FNS:
        raise ValueError(
            f"method must be tree|ring|bidir|swing, got {method!r}")
    leaves, rebuild = _flatten(tree)
    if presum_group is not None and dist.get_world_size(presum_group) > 1:
        leaves = [tree_allreduce(leaf, presum_group) for leaf in leaves]
    return rebuild(_bucketed(leaves, group, op, lambda dt, n: (method, wire)))


def device_allreduce_tree(tree, group: Optional[dist.ProcessGroup] = None,
                          op: int = SUM, method: str = "auto",
                          wire: Optional[str] = "auto"):
    """Bucketed allreduce of this rank's tree: one buffer per dtype, each
    bucket's method and wire resolved by ``dispatch.resolve`` on the
    bucket's total element count (so a tree of small leaves reaches the
    ring's sizes). An empty tree comes back as it is."""
    leaves, rebuild = _flatten(tree)
    if not leaves:
        return tree
    p = dist.get_world_size(group)
    plans, nbytes = {}, 0
    for dt, idxs in _by_dtype(leaves).items():
        n = sum(leaves[i].numel() for i in idxs)
        plans[dt] = _dispatch.resolve(n, dt, op, p, method=method, wire=wire,
                                      skew=_whole_world(group))
        isz = leaves[idxs[0]].element_size()
        nbytes += n * isz
        _profile.record_cost("allreduce_tree", plans[dt][0], plans[dt][1],
                             n, isz, p)
    sp = telemetry.span(
        "allreduce_tree", nbytes=nbytes, op=OP_NAMES.get(op, str(op)),
        method=",".join(sorted({m for m, _ in plans.values()})),
        buckets=len(plans), leaves=len(leaves))
    with sp:
        t0 = time.perf_counter()
        out = rebuild(_bucketed(leaves, group, op, lambda dt, n: plans[dt]))
        _finish(sp, out, t0)
    return out


def device_broadcast(x: torch.Tensor,
                     group: Optional[dist.ProcessGroup] = None,
                     root: int = 0) -> torch.Tensor:
    """Every rank gets rank ``root``'s ``x``: :func:`bcast_from_root`,
    under the JAX package's ``broadcast`` span."""
    n, isz = x.numel(), x.element_size()
    _profile.record_cost("broadcast", "psum_mask", None, n, isz,
                         dist.get_world_size(group))
    sp = telemetry.span("broadcast", nbytes=n * isz, method="psum_mask",
                        root=root)
    with sp:
        t0 = time.perf_counter()
        with telemetry.trace_annotation("rabit_broadcast"):
            out = bcast_from_root(x, group, root)
        _finish(sp, out, t0)
    return out


# ---------------------------------------------------------------------------
# The async layer: issue, overlap, wait. A ``*_async`` entry point runs the
# same schedule as its synchronous twin and returns a handle. How the design
# keeps its four rules:
#
# (a) Same order everywhere. Every collective, async or not, is issued by
#     the caller's thread, in program order; no worker thread exists that
#     could issue one rank's collectives in another order than its peers'.
# (b) No host wait on the card. On CUDA tensors the schedule is enqueued
#     on a side stream of the device (one per device), which first waits
#     on the caller's current stream through the stream itself, not the
#     host; an event recorded after the schedule is the handle's
#     ``ready()``. Issuing returns once the kernels and NCCL calls are
#     enqueued (the schedules hold no host synchronisation). On the CPU
#     (gloo) a collective blocks the calling thread, so the schedule runs
#     at issue and the handle is ready at once.
# (c) Safe ``value`` on the card. ``value`` makes the caller's current
#     stream wait on the event and marks the result as used on that stream
#     (``record_stream``); each input is marked as used on the side stream
#     at issue, so the caching allocator reuses no input before the
#     collective has read it, whatever the caller frees.
# (d) Same bits as sync. The handle runs the sync entry point's own
#     resolution and schedule on the same tensors; only the stream
#     differs.
#
# At most ``async_max_inflight()`` handles are in flight: admitting one
# past the cap waits on the oldest first. The window holds weak
# references, so a handle dropped without ``wait()`` is still found: it
# warns, counts ``async.dropped_handle``, disarms its guard and leaves the
# window.
#
# Telemetry: the issue is an ``<name>.issue`` span (the enqueue alone) and
# an ``async.issued`` count; ``wait()`` records the real span from issue
# to completion with ``wire_exposed_ms`` (the time the caller blocked in
# ``wait``) and ``wire_overlapped_ms`` (the rest), and the profiling
# plane's overlap (``collectives.py:1592-1686`` of the JAX package).
# ---------------------------------------------------------------------------

_ASYNC_ENV = "RABIT_ASYNC_COLLECTIVES"
_ASYNC_INFLIGHT_ENV = "RABIT_ASYNC_MAX_INFLIGHT"
ASYNC_MAX_INFLIGHT_DEFAULT = 4


def async_enabled() -> bool:
    """The knob of the overlapped pipelines (the models' async bucket
    steps): ``RABIT_ASYNC_COLLECTIVES``. The ``*_async`` entry points work
    regardless."""
    return os.environ.get(_ASYNC_ENV, "").lower() in ("1", "true", "yes",
                                                      "on")


def async_max_inflight() -> int:
    """The cap on async collectives in flight
    (``RABIT_ASYNC_MAX_INFLIGHT``, default 4, at least 1)."""
    try:
        return max(1, int(os.environ.get(_ASYNC_INFLIGHT_ENV,
                                         ASYNC_MAX_INFLIGHT_DEFAULT)))
    except ValueError:
        return ASYNC_MAX_INFLIGHT_DEFAULT


def configure_async(cfg) -> None:
    """Export the async knobs of an engine config (anything with
    ``get``) to the environment, so model code, which never sees the
    config, reads one source; the environment's value stays where the
    config is silent."""
    v = cfg.get("rabit_async_collectives")
    if v is not None:
        os.environ[_ASYNC_ENV] = str(v)
    v = cfg.get("rabit_async_max_inflight")
    if v is not None:
        os.environ[_ASYNC_INFLIGHT_ENV] = str(v)


_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT: list = []   # weak references to the handles in flight


def _admit(handle) -> None:
    # never wait while holding the lock: wait() retires, which locks
    while True:
        with _INFLIGHT_LOCK:
            _INFLIGHT[:] = [r for r in _INFLIGHT if r() is not None]
            if len(_INFLIGHT) < async_max_inflight():
                _INFLIGHT.append(weakref.ref(handle))
                return
            oldest = _INFLIGHT[0]()
        if oldest is not None:
            oldest.wait()


def _retire(handle) -> None:
    with _INFLIGHT_LOCK:
        _INFLIGHT[:] = [r for r in _INFLIGHT
                        if r() is not None and r() is not handle]


def inflight_count() -> int:
    with _INFLIGHT_LOCK:
        _INFLIGHT[:] = [r for r in _INFLIGHT if r() is not None]
        return len(_INFLIGHT)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device)


class AsyncHandle:
    """An async collective's result. ``value`` is the result, usable at
    once on the caller's stream (the stream waits for it on the card);
    ``ready()`` says without blocking whether it is complete; ``wait()``
    blocks until it is, disarms the guard, leaves the in-flight window,
    records the span ``name`` (``nbytes``, ``attrs``) with its
    exposed/overlapped split, and returns the result (after
    ``postprocess``); it is idempotent. Dropping a handle without
    ``wait()`` warns (``RuntimeWarning``): the collective still
    completes."""

    def __init__(self, out: torch.Tensor, *, name: str, event=None,
                 guard=None, postprocess=None, nbytes: int = 0,
                 attrs: Optional[dict] = None):
        self._out = out
        self._name = name
        self._event = event
        self._guard = guard            # armed by the issuing entry point
        self._post = postprocess
        self._nbytes = int(nbytes)
        self._attrs = attrs or {}
        self._done = False
        self._result = None
        self._t_issue = time.perf_counter()
        _admit(self)

    @property
    def value(self) -> torch.Tensor:
        if self._event is not None:
            stream = torch.cuda.current_stream(self._out.device)
            stream.wait_event(self._event)
            self._out.record_stream(stream)
        return self._out

    def ready(self) -> bool:
        return self._done or self._event is None or self._event.query()

    def wait(self):
        if self._done:
            return self._result
        t_wait = time.perf_counter()
        try:
            out = self.value
            if self._event is not None:
                self._event.synchronize()
        finally:
            self._done = True
            self._release()
        if telemetry.enabled() or _profile.enabled():
            self._account(t_wait, time.perf_counter())
        post, self._post = self._post, None
        self._result = post(out) if post else out
        return self._result

    def _account(self, t_wait: float, t_done: float) -> None:
        total = t_done - self._t_issue
        exposed = t_done - t_wait
        overlapped = max(0.0, total - exposed)
        attrs = dict(self._attrs, wire_exposed_ms=exposed * 1e3,
                     wire_overlapped_ms=overlapped * 1e3)
        telemetry.record_span(self._name, total, nbytes=self._nbytes,
                              **attrs)
        _profile.record_overlap(self._name, self._attrs.get("method"),
                                exposed, overlapped)

    def _release(self) -> None:
        guard, self._guard = self._guard, None
        if guard is not None:
            guard.__exit__(None, None, None)
        _retire(self)

    def __del__(self):
        try:
            if not self._done:
                self._done = True
                warnings.warn(
                    f"async collective handle '{self._name}' dropped "
                    "without wait(); result discarded and wire time "
                    "unaccounted", RuntimeWarning, stacklevel=2)
                telemetry.count("async.dropped_handle")
                self._release()
        except Exception:
            pass  # interpreter teardown: modules may be half-gone


class AsyncTreeHandle:
    """The handles of one tree's buckets (:func:`bucket_allreduce_async`):
    ``wait()`` waits on them oldest first and assembles the tree once."""

    def __init__(self, handles: Sequence[AsyncHandle], assemble):
        self._handles = list(handles)
        self._assemble = assemble
        self._done = False
        self._result = None

    @property
    def handles(self) -> Tuple[AsyncHandle, ...]:
        return tuple(self._handles)

    def ready(self) -> bool:
        return self._done or all(h.ready() for h in self._handles)

    def wait(self):
        if self._done:
            return self._result
        parts = [h.wait() for h in self._handles]
        assemble, self._assemble = self._assemble, None
        self._result = assemble(parts)
        self._done = True
        return self._result


def _issue(run: Callable[[], torch.Tensor], inputs: Sequence[torch.Tensor],
           name: str, attrs: dict, nbytes: int, issue=telemetry.NULL_SPAN,
           guard=None, postprocess=None) -> AsyncHandle:
    """Run ``run`` (a sync schedule over ``inputs``) as an async
    collective: on a CUDA device on its side stream, after the caller's
    stream, with an event behind it; on the CPU at once, inside the
    ``issue`` span (the entry point's ``<name>.issue``). ``guard`` (an
    unentered context manager) is armed now and disarmed by the handle.
    The handle records the span ``name`` of ``nbytes`` with ``attrs`` (op,
    method, wire, round, cost) at ``wait()``."""
    if guard is not None:
        guard.__enter__()
    try:
        dev = inputs[0].device
        event = None
        with issue:
            if dev.type == "cuda":
                side = _side_stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    out = run()
                    event = torch.cuda.Event()
                    event.record(side)
                for t in inputs:
                    t.record_stream(side)
            else:
                out = run()
    except BaseException:
        if guard is not None:
            guard.__exit__(None, None, None)
        raise
    return AsyncHandle(out, name=name, event=event, guard=guard,
                       postprocess=postprocess, nbytes=nbytes, attrs=attrs)


def _async_attrs(opname: str, method: str, wire: Optional[str], rnd: int,
                 extra: dict) -> dict:
    """An async handle's span attributes, as JAX's entry points build
    them."""
    attrs = {"op": opname, "method": method, "wire": wire, "round": rnd,
             "async": 1}
    attrs.update(extra)
    return attrs


def device_allreduce_async(x: torch.Tensor,
                           group: Optional[dist.ProcessGroup] = None,
                           op: int = SUM, method: str = "auto",
                           wire: Optional[str] = "auto", groups=None,
                           guard=None) -> AsyncHandle:
    """:func:`allreduce`, split into issue and wait; the method and wire
    are resolved at issue. ``guard`` (an unentered context manager, e.g. a
    watchdog's) covers issue to completion."""
    plan = _allreduce_plan(x, group, op, method, wire, groups)
    rnd = telemetry.collective_round("allreduce")
    telemetry.count("async.issued", nbytes=plan.nbytes, op=plan.opname,
                    method=plan.method, wire=plan.wire)
    issue = telemetry.span("allreduce.issue", nbytes=plan.nbytes,
                           op=plan.opname, method=plan.method,
                           wire=plan.wire, round=rnd, **plan.extra)
    return _issue(plan.run, [x], "allreduce",
                  _async_attrs(plan.opname, plan.method, plan.wire, rnd,
                               plan.extra), plan.nbytes, issue, guard=guard)


def grad_bucket_allreduce_async(x: torch.Tensor,
                                group: Optional[dist.ProcessGroup] = None,
                                op: int = SUM, method: str = "ring",
                                wire: Optional[str] = None,
                                guard=None) -> AsyncHandle:
    """One flat gradient bucket's data-parallel allreduce over ``group``
    (the dp group), issued without blocking: the models' async bucket
    steps. JAX's [dp, tp, n] bucket is this rank's row. Under skew
    adaptation it passes the agreement boundary at issue; its ``method``
    is explicit, so no plan applies (the JAX package's rule)."""
    flat = x.reshape(-1)
    if _skew.adapt_enabled():
        _skew_sync_point(group, flat.device)
    if wire == "auto":
        _, wire = _dispatch.resolve(flat.numel(), x.dtype, op,
                                    dist.get_world_size(group),
                                    method=method, wire="auto")
    wire = _normalize_wire(_canonical_wire(wire), op, x.dtype)
    nbytes, opname = flat.numel() * x.element_size(), OP_NAMES.get(op, str(op))
    extra = _cost_attrs(_profile.record_cost(
        "bucket_allreduce", method, wire, flat.numel(), x.element_size(),
        dist.get_world_size(group)))
    rnd = telemetry.collective_round("bucket_allreduce")
    telemetry.count("async.issued", nbytes=nbytes, op=opname, method=method,
                    wire=wire)
    issue = telemetry.span("bucket_allreduce.issue", nbytes=nbytes,
                           op=opname, method=method, wire=wire, round=rnd,
                           **extra)
    return _issue(lambda: _per_shard_allreduce(flat, group, op, method,
                                               wire),
                  [flat], "bucket_allreduce",
                  _async_attrs(opname, method, wire, rnd, extra), nbytes,
                  issue, guard=guard)


def grad_buckets_async(grads: Mapping[str, torch.Tensor],
                       group: Optional[dist.ProcessGroup] = None,
                       op: int = SUM, method: str = "ring"
                       ) -> List[Tuple[List[str], AsyncHandle]]:
    """The models' async bucket steps: ``grads`` (name -> tensor) as one
    flat buffer a dtype, the names in JAX's flatten order (sorted), each
    buffer's allreduce issued with :func:`grad_bucket_allreduce_async` in
    reverse bucket order. Returns ``(names, handle)`` in bucket order; a
    handle's ``value`` is the reduced buffer, the names' gradients in
    turn."""
    leaves, _ = _flatten(grads)
    keys = sorted(grads)
    buckets = [(idxs, _concat(leaves, idxs))
               for idxs in _by_dtype(leaves).values()]
    handles = [grad_bucket_allreduce_async(flat, group, op, method=method)
               for _, flat in reversed(buckets)][::-1]
    return [([keys[i] for i in idxs], h)
            for (idxs, _), h in zip(buckets, handles)]


def bucket_allreduce_async(tree, group: Optional[dist.ProcessGroup] = None,
                           op: int = SUM, method: str = "auto",
                           wire: Optional[str] = "auto") -> AsyncTreeHandle:
    """:func:`device_allreduce_tree`, issued bucket by bucket without
    blocking, in reverse bucket order (the late layers' gradients exist
    first under backpropagation: DDP's ready order). Each bucket's method
    and wire resolve on its total count; ``hier`` and ``preagg`` run the
    ring. Under skew adaptation the tree passes one agreement boundary at
    issue, and ``"auto"`` takes dispatch's skew-tolerant family (the JAX
    package's rules: no per-bucket plan). ``wait()`` returns the reduced
    tree."""
    leaves, rebuild = _flatten(tree)
    if not leaves:
        return AsyncTreeHandle([], lambda parts: tree)
    if _skew.adapt_enabled():
        _skew_sync_point(group, leaves[0].device)
    p = dist.get_world_size(group)
    opname = OP_NAMES.get(op, str(op))
    handles, issued = [], []
    for dt, idxs in reversed(list(_by_dtype(leaves).items())):
        flat = _concat(leaves, idxs)
        n, isz = flat.numel(), flat.element_size()
        mth, w = _dispatch.resolve(n, dt, op, p, method=method, wire=wire,
                                   skew=_whole_world(group))
        if mth in ("hier", "preagg"):
            mth = "ring"  # the bucket path runs flat schedules only
        extra = _cost_attrs(_profile.record_cost("bucket_allreduce", mth, w,
                                                 n, isz, p))
        rnd = telemetry.collective_round("bucket_allreduce")
        telemetry.count("async.issued", nbytes=n * isz, op=opname,
                        method=mth, wire=w)
        issue = telemetry.span("bucket_allreduce.issue", nbytes=n * isz,
                               op=opname, method=mth, wire=w, round=rnd,
                               buckets=1, leaves=len(idxs), **extra)
        handles.append(_issue(
            functools.partial(_per_shard_allreduce, flat, group, op, mth, w),
            [flat], "bucket_allreduce",
            _async_attrs(opname, mth, w, rnd, extra), n * isz, issue,
            postprocess=functools.partial(_split, leaves=leaves,
                                          idxs=idxs)))
        issued.append(idxs)

    def assemble(parts):
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for idxs, pieces in zip(issued, parts):
            for i, piece in zip(idxs, pieces):
                out[i] = piece
        return rebuild(out)

    return AsyncTreeHandle(handles, assemble)


def device_hier_allreduce_async(x: torch.Tensor,
                                group: Optional[dist.ProcessGroup] = None,
                                op: int = SUM, groups=None,
                                wire: Optional[str] = None,
                                inter_method: str = "ring",
                                guard=None) -> AsyncHandle:
    """:func:`device_hier_allreduce`, issued without blocking: the three
    phases are enqueued back to back; the one ``guard`` covers all of
    them (per-phase guards need the sync variant's boundaries). A grouping
    that is not two-level issues :func:`device_allreduce_async`. Skew
    adaptation as in :func:`device_hier_allreduce`, at issue."""
    groups, wire, adapted = _hier_setup(x, group, op, groups, wire,
                                        inter_method)
    if groups is None:
        return device_allreduce_async(x, group, op, method=inter_method,
                                      wire=wire, guard=guard)
    rnd = telemetry.collective_round("hier_allreduce")
    opname, isz = OP_NAMES.get(op, str(op)), x.element_size()
    g, hosts = len(groups[0]), len(groups)

    def issue_phase(ph: _Phase, fn):
        cost = _phase_cost(ph, isz, g)
        if adapted:
            cost["adapted"] = adapted
        with telemetry.span(ph.name + ".issue", nbytes=ph.nbytes, op=opname,
                            method=ph.method, wire=ph.wire, round=rnd,
                            phase=ph.phase, hosts=hosts, group_size=g,
                            **cost):
            return _labelled_phase(ph, fn)

    nbytes = x.numel() * isz
    telemetry.count("async.issued", nbytes=nbytes, op=opname, method="hier",
                    wire=wire)
    attrs = _async_attrs(opname, "hier", wire, rnd,
                         {"hosts": hosts, "group_size": g})
    if adapted:
        attrs["adapted"] = adapted
    # no issue span of its own: each phase opens one
    return _issue(lambda: _hier_run(x, group, op, groups, wire,
                                    inter_method, issue_phase),
                  [x], "hier_allreduce", attrs, nbytes, guard=guard)


# ---------------------------------------------------------------------------
# Differentiable pieces for the model-parallel regions of the transformer.
# torch tracks no varying-manual axes, so the port always uses the explicit
# conjugate pair (the formulation of JAX's unchecked shard_map): each
# function's backward is written out, not derived.
# ---------------------------------------------------------------------------

class _PsumIdentityGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return tree_allreduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentPsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tree_allreduce(g, ctx.group), None


def psum_identity_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` whose backward is the identity: where partial
    results leave a tensor-parallel region (Megatron's g). The port of
    ``rabit_tpu/parallel/collectives.py::psum_identity_grad``."""
    if dist.get_world_size(group) == 1:
        return x
    return _PsumIdentityGrad.apply(x, group)


def ident_psum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums the gradient over ``group``: where a
    replicated activation enters a tensor-parallel region (Megatron's f),
    so every shard's upstream gradient comes out complete. The port of
    ``ident_psum_grad``."""
    if dist.get_world_size(group) == 1:
        return x
    return _IdentPsumGrad.apply(x, group)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        p, idx = dist.get_world_size(group), dist.get_rank(group)
        out, = _exchange([x.contiguous()], (idx + 1) % p, (idx - 1) % p,
                         group)
        return out

    @staticmethod
    def backward(ctx, g):
        # the transpose of a rotation to the next rank: to the previous one
        p, idx = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        out, = _exchange([g.contiguous()], (idx - 1) % p, (idx + 1) % p,
                         ctx.group)
        return out, None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i's ``x`` to rank i+1 (mod p) of ``group``: one ``ppermute``
    step of the JAX ring, differentiable. The backward rotates the
    gradient to the previous rank; ``batch_isend_irecv`` alone has no
    autograd and would leave K/V without gradients across ranks."""
    if dist.get_world_size(group) == 1:
        return x
    return _RingShift.apply(x, group)


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int
                ) -> torch.Tensor:
    p = dist.get_world_size(group)
    n = x.shape[split_axis]
    if n % p:
        raise ValueError(f"all_to_all: axis {split_axis} of size {n} does "
                         f"not split over {p} ranks")
    # chunk j of the split axis to the front, to go to rank j; one
    # contiguous buffer of one dtype, as NCCL needs
    send = x.unflatten(split_axis, (p, n // p)).movedim(split_axis,
                                                        0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] came from rank j: concatenated along concat_axis in rank order
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        # the transpose of the exchange is the inverse exchange
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, ctx.group, concat_axis, split_axis), None, \
            None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """The tiled all-to-all over ``group``, differentiable: the port of
    ``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``.
    ``split_axis`` is cut into p chunks, chunk j goes to rank j, and what
    arrives is concatenated along ``concat_axis`` in rank order (one
    ``all_to_all_single``). Its backward is the inverse exchange, the two
    axes swapped."""
    if dist.get_world_size(group) == 1:
        return x
    split_axis %= x.dim()
    concat_axis %= x.dim()
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_part(g, ctx.group, ctx.dim), None, None


class _ShardAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_part(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _GatherAlong.apply(g, ctx.group, ctx.dim), None, None


def _own_part(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim] // p
    return x.narrow(dim, idx * n, n)


def shard_along(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim`` (rank order;
    the size must divide by p), whose backward gathers the blocks'
    gradients, so that a replicated input gets its whole gradient on
    every rank: a ``shard_map`` in-spec ``P(axis)`` over a global
    array."""
    if dist.get_world_size(group) == 1:
        return x
    if x.shape[dim] % dist.get_world_size(group):
        raise ValueError(f"axis {dim} of size {x.shape[dim]} does not "
                         f"divide over {dist.get_world_size(group)} ranks")
    return _ShardAlong.apply(x, group, dim % x.dim())


def gather_along(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in rank order, on every
    rank, whose backward takes this rank's block of the gradient (every
    rank computes the same loss from the replicated result, so no sum):
    a ``shard_map`` out-spec ``P(axis)`` read back as a global array."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherAlong.apply(x, group, dim % x.dim())

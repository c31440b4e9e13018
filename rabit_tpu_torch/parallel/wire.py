"""Block-wise wire codec and wire-spec grammar for the ring-family
collectives (EQuARX-style, arXiv:2506.17615): the port of
``rabit_tpu/parallel/wire.py``.

The collectives never ship whole payloads at reduced precision -- only
the bytes a point-to-point exchange carries are compressed, and
accumulation stays in f32 (``parallel/collectives.py``). This module
owns the two halves of that contract that are schedule-independent:

**The spec grammar** (copied unchanged). A wire spec is a string

    "<rs>[:<ag>][@<block>]"

where ``rs`` / ``ag`` are the reduce-scatter and all-gather phase
codecs (``bf16`` | ``int8`` | ``none``; a single codec with no colon
applies to both phases) and ``block`` is the int8 scaling-block size in
elements. :func:`canonical_wire` folds the ``rabit_wire_block`` env
default into any spec that doesn't pin its own block.

**The codec**, on tensors. ``bf16`` is a cast (round to nearest even,
half the bytes, no sidecar). ``int8`` is per-block symmetric
quantization: each ``block``-element block ships as int8 in [-127, 127]
plus one f32 max-abs scale, ``max(amax / 127, 1e-30)``, clamped BEFORE
both the division and the shipped value so encode and decode agree bit
for bit on every rank (the replay contract); the quotient rounds half to
even. The JAX codec is plain jnp, not a Pallas kernel, so its port is
plain torch: an IEEE division, ``amax`` and ``torch.round`` give the
same bits on the CPU and on the card (``chip_smoke.py`` checks the card
against the CPU, ``tests/test_torch_wire.py`` the CPU against JAX).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

WIRE_BLOCK_DEFAULT = 1024

_WIRE_BLOCK_ENV = "RABIT_WIRE_BLOCK"
_WIRE_RS_ENV = "RABIT_WIRE_RS"
_WIRE_AG_ENV = "RABIT_WIRE_AG"

_CODECS = ("bf16", "int8")


def wire_block() -> int:
    """Env-configured default int8 scaling-block size
    (``rabit_wire_block``; elements per shipped f32 scale). Falls back
    to ``WIRE_BLOCK_DEFAULT`` on unset/garbage — a wire knob must never
    crash dispatch."""
    raw = os.environ.get(_WIRE_BLOCK_ENV, "")
    if not raw:
        return WIRE_BLOCK_DEFAULT
    try:
        block = int(raw)
    except ValueError:
        return WIRE_BLOCK_DEFAULT
    return block if block > 0 else WIRE_BLOCK_DEFAULT


def _norm_codec(c: str, spec: str) -> Optional[str]:
    if c in ("", "none"):
        return None
    if c not in _CODECS:
        raise ValueError(
            f"wire spec {spec!r}: codec must be one of "
            f"{_CODECS + ('none',)}, got {c!r}")
    return c


def parse_wire(spec: Optional[str]
               ) -> Tuple[Optional[str], Optional[str], int]:
    """``spec -> (rs_codec, ag_codec, block)``. Pure and env-independent
    (a spec missing ``@block`` means ``WIRE_BLOCK_DEFAULT``): per-shard
    code parses the canonical spec it was traced with, never the live
    env — see :func:`canonical_wire`."""
    if spec is None:
        return None, None, WIRE_BLOCK_DEFAULT
    body, at, blk = str(spec).partition("@")
    block = WIRE_BLOCK_DEFAULT
    if at:
        try:
            block = int(blk)
        except ValueError:
            raise ValueError(
                f"wire spec {spec!r}: block must be an integer")
        if block <= 0:
            raise ValueError(
                f"wire spec {spec!r}: block must be positive")
    rs, colon, ag = body.partition(":")
    if not colon:
        ag = rs
    return _norm_codec(rs, spec), _norm_codec(ag, spec), block


def format_wire(rs: Optional[str], ag: Optional[str],
                block: int = WIRE_BLOCK_DEFAULT) -> Optional[str]:
    """Canonical spec string for the components, or None when both
    phases are unquantized (no-wire is spelled None, never "none")."""
    if rs is None and ag is None:
        return None
    body = (rs or "none") if rs == ag else f"{rs or 'none'}:{ag or 'none'}"
    if block != WIRE_BLOCK_DEFAULT:
        body += f"@{block}"
    return body


def canonical_wire(spec: Optional[str]) -> Optional[str]:
    """Host-side canonicalization — the ONLY place the env block knob
    enters a spec: a spec that doesn't pin ``@block`` gets the live
    ``rabit_wire_block`` value folded in (in the JAX package specs are
    static jit keys, so this is where two env blocks part)."""
    if spec in (None, "", "none", "off"):
        return None
    rs, ag, block = parse_wire(spec)
    if "@" not in str(spec):
        block = wire_block()
    return format_wire(rs, ag, block)


def phase_request(base: Optional[str]) -> Optional[str]:
    """Compose the env-requested wire spec from the base codec
    (``rabit_dataplane_wire``) and the per-phase overrides
    (``rabit_wire_rs`` / ``rabit_wire_ag``). Either override alone is a
    request — ``rabit_wire_rs=int8`` with no base quantizes only the
    reduce-scatter hops. Returns a canonical spec or None."""
    rs = os.environ.get(_WIRE_RS_ENV) or base
    ag = os.environ.get(_WIRE_AG_ENV) or base
    if rs in (None, "", "none", "off"):
        rs = None
    if ag in (None, "", "none", "off"):
        ag = None
    if rs is None and ag is None:
        return None
    if rs not in _CODECS + (None,) or ag not in _CODECS + (None,):
        return None  # garbage env: a knob must never crash dispatch
    return format_wire(rs, ag, wire_block())


def wire_itemsize(spec: Optional[str], itemsize: float) -> float:
    """Mean shipped bytes per element under ``spec`` (RS and AG phases
    averaged — each carries half the round trip), used by the analytic
    cost model and the adaptive election. ``itemsize`` is the raw
    element size the unquantized phases ship."""
    if spec is None:
        return float(itemsize)
    rs, ag, block = parse_wire(spec)
    per = {None: float(itemsize), "bf16": 2.0,
           "int8": 1.0 + 4.0 / block}
    return (per[rs] + per[ag]) / 2.0


def encode(x: torch.Tensor, codec: str,
           block: int = WIRE_BLOCK_DEFAULT) -> Tuple[torch.Tensor, ...]:
    """Encode a tensor for the wire: a tuple of tensors to exchange.
    ``bf16`` casts; ``int8`` block-quantizes (the element count must tile
    into ``block``-element blocks) and ships the f32 max-abs scales as a
    sidecar [nblocks, 1]."""
    if codec == "bf16":
        return (x.to(torch.bfloat16),)
    if codec != "int8":
        raise ValueError(f"unknown wire codec {codec!r}")
    # int8: per-block symmetric scale, values in [-127, 127]. The scale
    # is clamped BEFORE both the division and the shipped value so
    # encode and decode agree (an unclamped shipped scale would decode
    # denormal-scale blocks up to 127x too small).
    # The divisor is a tensor on x's device, not a Python number: on CUDA
    # torch divides by a host scalar as a product with its reciprocal,
    # which is not the IEEE quotient and moves the scale by an ULP.
    blocks = x.reshape(-1, block)
    scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True)
                            / blocks.new_full((), 127.0), 1e-30)
    q = torch.round(blocks / scale).to(torch.int8)
    return q, scale.to(torch.float32)


def decode(enc: Sequence[torch.Tensor], codec: str, shape) -> torch.Tensor:
    """Inverse of :func:`encode`; always returns f32 (the EQuARX
    accumulate-in-full-precision half of the contract -- callers cast
    down only at the very end)."""
    if codec == "bf16":
        return enc[0].to(torch.float32).reshape(shape)
    q, scale = enc
    return (q.to(torch.float32) * scale).reshape(shape)

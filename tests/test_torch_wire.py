"""The port's wire codec and spec grammar (``rabit_tpu_torch/parallel/
wire.py``) against ``rabit_tpu.parallel.wire``: the grammar on the same
specs and environment, the codec's encodings and decodings bit for bit.

Both sides divide in IEEE f32, take the block's max |x| and round half to
even, so the int8 codes, the scales and the decoded values agree exactly
(no tolerance: a difference of one code would break the replay contract
between a JAX rank and a torch rank reading the same bytes)."""

import numpy as np
import pytest
import torch

from rabit_tpu.parallel import wire as jw
from rabit_tpu_torch.parallel import wire as tw

SPECS = ["bf16", "int8", "int8:bf16", "bf16:int8", "none:int8",
         "int8:none", "int8@256", "int8@4096", "int8:bf16@512", "none",
         "none:none", "bf16@2048", ":int8", "int8:", None]
JUNK = ["fp8", "int8@0", "int8@x", "bf16:fp4", "int8@-4", "int4:bf16"]
ENV = ("RABIT_WIRE_BLOCK", "RABIT_WIRE_RS", "RABIT_WIRE_AG")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_matches_rabit_tpu(clean_env, spec):
    assert tw.parse_wire(spec) == jw.parse_wire(spec)
    assert tw.format_wire(*tw.parse_wire(spec)) == \
        jw.format_wire(*jw.parse_wire(spec))
    for itemsize in (4, 2):
        assert tw.wire_itemsize(spec, itemsize) == \
            jw.wire_itemsize(spec, itemsize)
    for block in (None, "512", "junk", "0"):
        if block is None:
            clean_env.delenv("RABIT_WIRE_BLOCK", raising=False)
        else:
            clean_env.setenv("RABIT_WIRE_BLOCK", block)
        assert tw.wire_block() == jw.wire_block()
        assert tw.canonical_wire(spec) == jw.canonical_wire(spec)


@pytest.mark.parametrize("spec", JUNK)
def test_grammar_refuses_what_rabit_tpu_refuses(spec):
    for mod in (tw, jw):
        with pytest.raises(ValueError):
            mod.parse_wire(spec)


@pytest.mark.parametrize("base", [None, "bf16", "int8", "off", "fp8"])
@pytest.mark.parametrize("rs,ag", [(None, None), ("int8", None),
                                   (None, "bf16"), ("int8", "bf16"),
                                   ("junk", None)])
def test_phase_request_matches_rabit_tpu(clean_env, base, rs, ag):
    for key, val in (("RABIT_WIRE_RS", rs), ("RABIT_WIRE_AG", ag)):
        if val is not None:
            clean_env.setenv(key, val)
    clean_env.setenv("RABIT_WIRE_BLOCK", "256")
    assert tw.phase_request(base) == jw.phase_request(base)


def _payload(n: int, seed: int) -> np.ndarray:
    """Normal values scaled by block-wise magnitudes from 2^-40 to 2^39,
    a zero block, a block of quotients on .5 (round half to even), and
    the f32 extremes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x *= np.exp2((np.arange(n) // 64) % 80 - 40.0).astype(np.float32)
    x[:64] = 0.0
    x[64:128] = np.arange(64, dtype=np.float32) * 0.5
    x[128] = np.finfo(np.float32).max
    x[200] = np.finfo(np.float32).tiny
    x[300] = -np.finfo(np.float32).smallest_subnormal
    return x


def _bits(a) -> bytes:
    a = np.asarray(a)
    return a.view(np.uint16).tobytes() if a.dtype.itemsize == 2 and \
        a.dtype.kind not in "iu" else a.tobytes()


@pytest.mark.parametrize("codec,block", [("bf16", 1024), ("int8", 64),
                                         ("int8", 256), ("int8", 512),
                                         ("int8", 1024), ("int8", 4096)])
@pytest.mark.parametrize("shape", [(8192,), (4, 2048)])
def test_codec_bit_for_bit_against_rabit_tpu(codec, block, shape):
    x = _payload(int(np.prod(shape)), 11).reshape(shape)
    want = jw.encode(x, codec, block)
    got = tw.encode(torch.from_numpy(x), codec, block)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == torch.bfloat16:
            g = g.view(torch.int16)
        assert tuple(g.shape) == tuple(np.shape(w))
        assert _bits(g.numpy()) == _bits(w), codec
    dec_w = np.asarray(jw.decode(want, codec, shape))
    dec_g = tw.decode(got, codec, shape)
    assert dec_g.dtype == torch.float32
    assert dec_g.numpy().tobytes() == dec_w.tobytes()


def test_int8_codes_stay_in_range_and_scales_clamp():
    x = torch.zeros(2048)
    x[1024:] = torch.linspace(-3.0, 3.0, 1024)
    q, scale = tw.encode(x, "int8", 1024)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale[0, 0].item() == np.float32(1e-30)   # the all-zero block
    assert int(q.abs().max()) == 127
    assert torch.equal(tw.decode((q, scale), "int8", x.shape)[:1024],
                       torch.zeros(1024))


def test_unknown_codec_raises():
    with pytest.raises(ValueError, match="codec"):
        tw.encode(torch.zeros(4), "fp8")

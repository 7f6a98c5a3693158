"""D2's plain version and the port's chunked Huffman decode against the JAX
package, on the CPU.

* on the (u, n) cases of tests/test_hufdec.py the port decodes the ids of
  JAX's `decode_payload_device` and of the native bit-serial walker, and
  pass 1 of the plain version gives JAX's `_pass1` exits, counts and
  frozen flag;
* the deep-code stream: both decline, or both decode the same ids;
* the small-payload and oversize declines (the cap monkeypatched on both
  sides) return None exactly where JAX does, and are counted;
* the CNIIC_DEVICE_HUF_DECODE=1 round trip engages the device path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cniic_tpu.ops import hufdec as jax_hufdec
from cniic_tpu_torch import huffman, native
from cniic_tpu_torch.codecs import from_spec
from cniic_tpu_torch.ops import hufdec


def _stream(freqs, ids):
    book = huffman.build_codebook(freqs)
    leafs = np.zeros((freqs.size, 1), np.uint8)
    tree = huffman.serialize_tree(book, leafs)
    payload = huffman.encode_payload(ids.astype(np.int32), book, device=False)
    left, right, symbol, _, _ = huffman.parse_tree(
        np.frombuffer(tree, np.uint8), 1)
    return payload, left, right, symbol


@pytest.mark.parametrize("u,n", [(300, 40_000), (2, 30_000), (4096, 60_000)])
def test_decode_matches_jax_and_walker(u, n, rng):
    freqs = rng.integers(1, 1000, u).astype(np.uint64)
    ids = rng.integers(0, u, n)
    payload, left, right, symbol = _stream(freqs, ids)
    want = native.huf_decode(payload, left, right, symbol, 0, n, fast=False)
    jax_got = jax_hufdec.decode_payload_device(payload, left, right, symbol, n)
    got = hufdec.decode_payload_device(payload, left, right, symbol, n,
                                       device="cpu")
    assert got is not None and jax_got is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_got)


@pytest.mark.parametrize("u,n", [(300, 40_000), (2, 30_000)])
def test_pass1_matches_jax(u, n, rng):
    freqs = rng.integers(1, 1000, u).astype(np.uint64)
    payload, left, right, symbol = _stream(freqs, rng.integers(0, u, n))
    pay = np.frombuffer(payload, np.uint8)
    total = 8 * pay.size
    C = -(-pay.size // hufdec.CHUNK_BYTES)
    bits = hufdec.CHUNK_BYTES * 8
    starts = (np.arange(C)[:, None] * bits
              + np.arange(hufdec.E)[None, :]).reshape(-1).astype(np.int32)
    ends = np.repeat(np.minimum((np.arange(C) + 1) * bits, total),
                     hufdec.E).astype(np.int32)
    lr2 = hufdec._lr2(left, right, symbol)
    np.testing.assert_array_equal(lr2, jax_hufdec._lr2(left, right, symbol))
    exits, cnts, ok = jax_hufdec._pass1(
        jnp.asarray(pay), jnp.asarray(lr2), jnp.asarray(starts),
        jnp.asarray(ends), jnp.int32(total), hufdec._STEPS)
    got = hufdec.walk(torch.from_numpy(pay.copy()), torch.from_numpy(lr2),
                      torch.from_numpy(starts), torch.from_numpy(ends), total)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exits))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(cnts))
    assert got[2] == bool(ok) and got[3] is None


@pytest.mark.parametrize("n_bytes", [1, 512, 513, 40_000, (1 << 28) - 1])
def test_chunk_bounds_match_jax_int64_arithmetic(n_bytes):
    """Chunk starts and ends equal JAX's int64-then-clamp arithmetic, up to
    the largest payload under the cap (2^19 chunks, the last ending just
    under 2^31 bits), where an int32 end would wrap negative."""
    starts, ends = hufdec.chunk_bounds(n_bytes)
    C = -(-n_bytes // hufdec.CHUNK_BYTES)
    bits = hufdec.CHUNK_BYTES * 8
    want_ends = np.minimum((np.arange(C, dtype=np.int64) + 1) * bits,
                           8 * n_bytes)
    assert starts.dtype == ends.dtype == np.int32 and starts.size == C
    np.testing.assert_array_equal(starts, np.arange(C, dtype=np.int64) * bits)
    np.testing.assert_array_equal(ends, want_ends)
    assert int(ends[-1]) == 8 * n_bytes and (ends > starts).all()


@pytest.mark.parametrize("u,seed", [(40, 0), (48, 1)])
def test_deep_codes_decline_or_match_like_jax(u, seed):
    """Geometric frequencies force code lengths beyond E: the port declines
    exactly where JAX does, and otherwise decodes JAX's ids."""
    rng = np.random.default_rng(seed)
    freqs = (2.0 ** np.arange(u)).astype(np.uint64)
    ids = rng.integers(0, u, 30_000)
    payload, left, right, symbol = _stream(freqs, ids)
    jax_got = jax_hufdec.decode_payload_device(payload, left, right, symbol,
                                               ids.size)
    before = hufdec.declines
    got = hufdec.decode_payload_device(payload, left, right, symbol,
                                       ids.size, device="cpu")
    assert (got is None) == (jax_got is None)
    assert hufdec.declines == before + (got is None)
    if got is not None:
        np.testing.assert_array_equal(got, jax_got)


def test_small_payload_and_oversize_decline_like_jax(rng, monkeypatch):
    freqs = np.array([5, 5, 5], np.uint64)
    small = _stream(freqs, rng.integers(0, 3, 50))
    assert jax_hufdec.decode_payload_device(*small, 50) is None
    before = hufdec.declines
    assert hufdec.decode_payload_device(*small, 50, device="cpu") is None
    # no symbols asked for, and a payload too short for the count asked
    freqs = rng.integers(1, 1000, 300).astype(np.uint64)
    ids = rng.integers(0, 300, 40_000)
    big = _stream(freqs, ids)
    for n in (0, ids.size + 5000):
        assert jax_hufdec.decode_payload_device(*big, n) is None
        assert hufdec.decode_payload_device(*big, n, device="cpu") is None
    assert hufdec.declines == before + 3
    # the int32-position cap, shrunk on both sides
    assert len(big[0]) >= hufdec.CHUNK_BYTES
    monkeypatch.setattr(jax_hufdec, "_MAX_PAYLOAD_BYTES", len(big[0]))
    monkeypatch.setattr(hufdec, "_MAX_PAYLOAD_BYTES", len(big[0]))
    assert jax_hufdec.decode_payload_device(*big, ids.size) is None
    assert hufdec.decode_payload_device(*big, ids.size, device="cpu") is None
    monkeypatch.setattr(hufdec, "_MAX_PAYLOAD_BYTES", len(big[0]) + 1)
    np.testing.assert_array_equal(
        hufdec.decode_payload_device(*big, ids.size, device="cpu"),
        native.huf_decode(*big, 0, ids.size))


def test_step_budget_is_fixed(rng):
    """A lane that needs more than n_steps steps is reported unfrozen: the
    walk stops at the budget instead of running until it freezes."""
    freqs = rng.integers(1, 1000, 300).astype(np.uint64)
    payload, left, right, symbol = _stream(freqs, rng.integers(0, 300, 5000))
    pay = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    lr2 = torch.from_numpy(hufdec._lr2(left, right, symbol))
    starts = torch.zeros(1, dtype=torch.int32)
    ends = torch.full((1,), 4096, dtype=torch.int32)
    exits, cnts, frozen, _ = hufdec.walk(pay, lr2, starts, ends,
                                         8 * len(payload), n_steps=4000)
    assert not frozen and int(exits[0]) == 4000 - 4096
    assert hufdec.walk(pay, lr2, starts, ends, 8 * len(payload))[2]


def test_env_gate_roundtrip(rng, monkeypatch):
    """CNIIC_DEVICE_HUF_DECODE=1 routes decode_payload through the device
    path (here D2's plain version): the codec round trip stays exact and
    the device path engaged."""
    img = rng.integers(0, 256, (96, 96, 3)).astype(np.uint8)
    codec = from_spec("hufman", device="cpu")
    data = codec.encode(img)
    monkeypatch.setenv("CNIIC_DEVICE_HUF_DECODE", "1")
    engaged = []
    real = hufdec.decode_payload_device

    def spy(*a, **k):
        out = real(*a, **k)
        engaged.append(out is not None)
        return out

    monkeypatch.setattr(hufdec, "decode_payload_device", spy)
    np.testing.assert_array_equal(codec.decode(data), img)
    assert engaged == [True], "device decode path never engaged"

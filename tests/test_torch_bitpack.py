"""D1's plain version and the port's device bit packer against the JAX
package, on the CPU.

* `pack_words_ref` gives the words of JAX's `_pack_core` (jitted on its CPU
  backend) on ragged batches with padding ids and on 63-bit codes;
* `pack_bits_device` and `pack_bits_batch` on a CPU device give JAX's bytes,
  the native C packer's and the numpy oracle's;
* the 2^31-bit refusal raises as JAX's does, and the wrapper refuses what
  the kernel does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cniic_tpu import huffman as jax_huffman
from cniic_tpu.ops import bitpack as jax_bitpack
from cniic_tpu_torch import huffman, native, wire
from cniic_tpu_torch.ops import bitpack


def _codebooks(rng, us, deep=False):
    """Per-stream codebooks padded to [B, max(u) + 1] (the extra entry is
    zero-length); a geometric codebook of 64 symbols reaches 63 bits."""
    u_pad = max(us) + 1
    codes = np.zeros((len(us), u_pad), np.uint64)
    lens = np.zeros((len(us), u_pad), np.uint32)
    for b, u in enumerate(us):
        freqs = (2 ** np.arange(u, dtype=np.uint64) if deep
                 else rng.integers(1, 5000, u).astype(np.uint64))
        book = huffman.build_codebook(freqs)
        codes[b, :u], lens[b, :u] = book.codes, book.lens
    return codes, lens


def _ragged_ids(rng, us, n):
    ids = np.empty((len(us), n), np.int32)
    for b, u in enumerate(us):
        m = n - 113 * b
        ids[b, :m] = rng.integers(0, u, m)
        ids[b, m:] = u  # padding -> the zero-length entry
    return ids


def _split(codes):
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = codes.astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("us,deep", [((300, 17, 2, 1000), False),
                                     ((64, 64), True),
                                     ((1,), False)])
def test_plain_version_matches_jax_pack_core(us, deep):
    rng = np.random.default_rng(len(us))
    codes, lens = _codebooks(rng, us, deep)
    if deep:
        assert lens.max() == 63
    ids = _ragged_ids(rng, us, 3000)
    hi, lo = _split(codes)
    n_words = 2 * ids.shape[1] + 2
    got = bitpack.pack_words_ref(
        *[torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
          for a in (ids, hi, lo, lens.astype(np.int32))], n_words)
    for b in range(len(us)):
        want, bits = jax_bitpack._pack_device(
            jnp.asarray(ids[b]), jnp.asarray(hi[b]), jnp.asarray(lo[b]),
            jnp.asarray(lens[b].astype(np.int32)), n_words=n_words)
        np.testing.assert_array_equal(got[b].numpy().view(np.uint32),
                                      np.asarray(want))


@pytest.mark.parametrize("us,deep", [((300, 17, 2, 1000), False),
                                     ((64, 40), True)])
def test_batch_bytes_match_jax_and_native(us, deep):
    rng = np.random.default_rng(7)
    codes, lens = _codebooks(rng, us, deep)
    ids = _ragged_ids(rng, us, 4096)
    want = jax_bitpack.pack_bits_batch(ids, codes, lens)
    got = bitpack.pack_bits_batch(ids, codes, lens, device="cpu")
    assert got == want
    totals = [int(lens[b][ids[b]].astype(np.int64).sum())
              for b in range(len(us))]
    assert bitpack.pack_bits_batch(ids, codes, lens, totals,
                                   device="cpu") == want
    for b, u in enumerate(us):
        real = ids[b][ids[b] < u]
        assert got[b] == native.pack_bits(codes[b, :u], lens[b, :u], real)
        assert got[b] == bitpack.pack_bits_numpy(codes[b][real], lens[b][real])


@pytest.mark.parametrize("u,n", [(64, 3000), (2, 777), (5000, 20_000)])
def test_single_stream_matches_jax(u, n):
    rng = np.random.default_rng(u)
    freqs = rng.integers(1, 5000, u).astype(np.uint64)
    book = huffman.build_codebook(freqs)
    ids = rng.integers(0, u, n).astype(np.int32)
    got = bitpack.pack_bits_device(ids, book.codes, book.lens, device="cpu")
    assert got == jax_bitpack.pack_bits_device(ids, book.codes, book.lens)
    assert got == native.pack_bits(book.codes, book.lens, ids)


def test_long_codes_and_bitwriter():
    """Codes up to 63 bits span three 32-bit words; the packer equals the
    sequential MSB-first writer."""
    codes = np.array([(1 << 63) - 1, 0, 5, 0b0110011], np.uint64)
    lens = np.array([63, 1, 3, 7], np.uint32)
    ids = np.array([0, 1, 0, 2, 1, 0, 3, 3, 0], np.int32)
    bw = wire.BitWriter()
    for i in ids:
        bw.write_bits(int(codes[i]), int(lens[i]))
    bw.pad_and_flush()
    got = bitpack.pack_bits_device(ids, codes, lens, device="cpu")
    assert got == bw.getvalue()
    assert got == jax_bitpack.pack_bits_device(ids, codes, lens)


def test_refuses_2_31_payload_bits_like_jax():
    """The worst case (max len x stream length) at or past 2^31 bits is
    refused unless the exact totals say otherwise; a broadcast view keeps
    the 40M-id stream free."""
    codes = np.array([[(1 << 62) + 1, 0]], np.uint64)
    lens = np.array([[63, 0]], np.uint32)
    ids = np.broadcast_to(np.zeros((1, 1), np.int32), (1, 40_000_000))
    for total in (None, [1 << 30]):
        with pytest.raises(ValueError) as jax_err:
            jax_bitpack.pack_bits_batch(ids, codes, lens, total)
        with pytest.raises(ValueError) as port_err:
            bitpack.pack_bits_batch(ids, codes, lens, total, device="cpu")
        assert str(port_err.value) == str(jax_err.value)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ids = torch.zeros((2, 10), dtype=torch.int32)
    book = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.ones((2, 4), dtype=torch.int32)
    bitpack.pack_words(ids, book, book, lens, 4)  # accepted
    with pytest.raises(TypeError):
        bitpack.pack_words(ids.long(), book, book, lens, 4)
    with pytest.raises(ValueError, match="ids must lie"):
        bitpack.pack_words(ids + 4, book, book, lens, 4)
    with pytest.raises(ValueError, match="code lengths"):
        bitpack.pack_words(ids, book, book, lens * 64, 4)
    with pytest.raises(ValueError, match="shape"):
        bitpack.pack_words(ids, book, book, lens[:, :3].contiguous(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        bitpack.pack_words(ids.t().contiguous().t(), book, book, lens, 4)
    with pytest.raises(ValueError, match="unsupported device|runs on"):
        bitpack.pack_words(ids.to("meta"), book.to("meta"), book.to("meta"),
                           lens.to("meta"), 4)


def test_encode_payload_gate_matches_jax(monkeypatch):
    """CNIIC_DEVICE_BITPACK=1 sends encode_payload through D1's plain
    version on a CPU device: the bytes equal the C packer's and JAX's gated
    route's; with no card the default device is refused."""
    rng = np.random.default_rng(12)
    freqs = rng.integers(1, 1000, 300)
    ids = rng.integers(0, 300, 5000).astype(np.int32)
    book = huffman.build_codebook(freqs)
    want = huffman.encode_payload(ids, book)
    calls = []
    real = bitpack.pack_words_ref

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(bitpack, "pack_words_ref", spy)
    monkeypatch.setenv("CNIIC_DEVICE_BITPACK", "1")
    got = huffman.encode_payload(ids, book, torch_device="cpu")
    assert calls == [(1, ids.size)]
    assert got == want
    assert got == jax_huffman.encode_payload(
        ids, jax_huffman.build_codebook(freqs))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            huffman.encode_payload(ids, book)  # cuda by default


@pytest.mark.parametrize("gated", [False, True])
def test_batch_encode_ragged_matches_jax(gated, monkeypatch):
    """huffman.batch_encode over streams of different lengths and alphabets
    gives JAX's streams, on the C packer and under CNIIC_DEVICE_BITPACK=1,
    and they decode back to the keys."""
    rng = np.random.default_rng(3)
    keys = [rng.integers(0, 50, n).astype(np.uint32) for n in (17, 5000, 1)]

    def payload_fn(u):
        return np.repeat(u.astype(np.uint8)[:, None], 6, axis=1)

    if gated:
        monkeypatch.setenv("CNIIC_DEVICE_BITPACK", "1")
    streams = huffman.batch_encode(keys, payload_fn, torch_device="cpu")
    assert streams == jax_huffman.batch_encode(keys, payload_fn)
    for k, s in zip(keys, streams):
        payloads, ids = huffman.decode_stream(s, 6, k.size, torch_device="cpu")
        np.testing.assert_array_equal(payloads[ids][:, 0].astype(np.uint32), k)

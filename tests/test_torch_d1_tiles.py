"""D1's one-pass schedule held on the CPU: `bitpack.pack_words_tiled_model`
(the kernel's tiles in numpy: the scan inside a tile, the base carried from
the tiles before it, a word buffer a tile, whole words stored and the two
edge words ORed) against D1's plain version `pack_words_ref` and against
the JAX package's `_pack_core`, word for word.

The cases sit on the schedule's edges at small tile sizes: codes that
straddle a tile edge and a word edge, 63-bit codes (three words a code),
zero-length padding at tile edges and whole tiles of it, a stream length
that is no multiple of the tile, tiles whose bits fit inside one word that
three tiles share, and an `n_words` that cuts the last tile or falls
before it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cniic_tpu.ops import bitpack as jax_bitpack
from cniic_tpu_torch import huffman
from cniic_tpu_torch.ops import bitpack


def _book(freqs):
    book = huffman.build_codebook(np.asarray(freqs, np.uint64))
    return book.codes, book.lens


def _operands(ids, codes, lens):
    """[B, n] ids and [B, u] codes/lens -> the int32 arrays of `pack_words`
    (one zero-length entry appended to every codebook)."""
    codes = np.concatenate([codes, np.zeros((codes.shape[0], 1), np.uint64)], 1)
    lens = np.concatenate([lens, np.zeros((lens.shape[0], 1), np.uint32)], 1)
    hi = (codes >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = codes.astype(np.uint32).view(np.int32)
    return (np.ascontiguousarray(ids, np.int32), hi, lo,
            lens.astype(np.int32))


def _agree(ops, n_words, tile):
    got = bitpack.pack_words_tiled_model(*ops, n_words, tile=tile)
    want = bitpack.pack_words_ref(*[torch.from_numpy(a) for a in ops], n_words)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
    ids, hi, lo, lens = ops
    for b in range(ids.shape[0]):
        jax_words, _ = jax_bitpack._pack_device(
            jnp.asarray(ids[b]), jnp.asarray(hi[b].view(np.uint32)),
            jnp.asarray(lo[b].view(np.uint32)), jnp.asarray(lens[b]),
            n_words=n_words)
        np.testing.assert_array_equal(got[b], np.asarray(jax_words))
    return got


def _total_words(ops):
    ids, _, _, lens = ops
    bits = np.take_along_axis(lens, ids, 1).astype(np.int64).sum(1)
    return int((bits.max() + 31) // 32)


@pytest.mark.parametrize("tile", [1, 3, 8, 64, 2048])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_tiles_match_plain_version_and_jax(tile, n):
    """Ragged random streams: n on, below and above the tile's multiples."""
    rng = np.random.default_rng(1000 * tile + n)
    us = (300, 17, 2)
    books = [_book(rng.integers(1, 5000, u)) for u in us]
    u_max = max(us)
    codes = np.zeros((len(us), u_max), np.uint64)
    lens = np.zeros((len(us), u_max), np.uint32)
    ids = np.empty((len(us), n), np.int32)
    for b, (u, (c, ln)) in enumerate(zip(us, books)):
        codes[b, :u], lens[b, :u] = c, ln
        m = max(n - 5 * b, 0)
        ids[b, :m] = rng.integers(0, u, m)
        ids[b, m:] = u_max       # padding -> the appended zero-length entry
    ops = _operands(ids, codes, lens)
    _agree(ops, _total_words(ops) + 2, tile)


@pytest.mark.parametrize("tile", [1, 2, 5, 16])
def test_63_bit_codes_straddle_tiles_and_words(tile):
    """A geometric codebook reaches 63 bits: every code spans two or three
    words, and at these tiles most straddle a tile's edge word."""
    rng = np.random.default_rng(tile)
    codes, lens = _book(2 ** np.arange(64, dtype=np.uint64))
    assert lens.max() == 63
    ids = rng.integers(0, 64, (2, 97)).astype(np.int32)
    ids[1, ::3] = 0 if lens[0] == 63 else int(np.argmax(lens))
    ops = _operands(ids, np.stack([codes, codes]), np.stack([lens, lens]))
    got = _agree(ops, _total_words(ops), tile)
    assert got.any()


@pytest.mark.parametrize("tile", [4, 8])
def test_zero_length_padding_at_tile_edges(tile):
    """Zero-length entries at the first and last symbol of tiles, whole
    tiles of them (a tile that adds no bit between two that share a word),
    and a stream of nothing else."""
    codes, lens = _book([5, 9, 1, 1, 30])
    pad = codes.size
    rng = np.random.default_rng(3)
    n = 6 * tile + 3
    ids = rng.integers(0, pad, (3, n)).astype(np.int32)
    ids[0, tile - 1::tile] = pad        # last symbol of every tile
    ids[0, ::tile] = pad                # first symbol of every tile
    ids[1, tile:3 * tile] = pad         # two whole tiles of padding
    ids[2] = pad                        # all-zero lengths
    ops = _operands(ids, np.stack([codes] * 3), np.stack([lens] * 3))
    got = _agree(ops, _total_words(ops) + 1, tile)
    assert not got[2].any()


def test_tiles_smaller_than_a_word_share_it():
    """One-bit codes at tile 3: ten tiles put their bits into one word, all
    of them through the edge-word OR."""
    codes, lens = _book([1, 1])
    assert lens.tolist() == [1, 1]
    ids = np.random.default_rng(0).integers(0, 2, (1, 100)).astype(np.int32)
    ops = _operands(ids, codes[None], lens[None])
    _agree(ops, 4, 3)


@pytest.mark.parametrize("cut", [0, 1, 2, 7])
def test_n_words_cuts_the_last_tiles(cut):
    """Bits at or past `n_words` are dropped: the cut falls inside the last
    tile, on its first word, and tiles before the end."""
    rng = np.random.default_rng(cut)
    codes, lens = _book(rng.integers(1, 400, 40))
    ids = rng.integers(0, 40, (2, 150)).astype(np.int32)
    ops = _operands(ids, np.stack([codes] * 2), np.stack([lens] * 2))
    full = _total_words(ops)
    whole = _agree(ops, full, 16)
    got = _agree(ops, max(full - cut, 0), 16)
    np.testing.assert_array_equal(got, whole[:, :max(full - cut, 0)])


def test_model_tile_is_the_kernels():
    """The default tile of the model is the kernel's (256 threads of 8
    symbols), and a tile's buffer holds its worst case: 63 bits a symbol
    after 31 bits of a shared first word."""
    assert bitpack.TILE == 2048
    codes, lens = _book(2 ** np.arange(64, dtype=np.uint64))
    deepest = int(np.argmax(lens))
    ids = np.full((1, 2 * bitpack.TILE + 1), deepest, np.int32)
    ids[0, 0] = int(np.argmin(lens))     # 1 bit: every tile after starts
    ops = _operands(ids, codes[None], lens[None])   # off a word edge
    _agree(ops, _total_words(ops), bitpack.TILE)

"""D2: the chunked self-synchronizing Huffman decode on a device (the
env-gated CNIIC_DEVICE_HUF_DECODE=1 route) and its plain version.

Port of ``cniic_tpu/ops/hufdec.py`` (SURVEY §7.3 item 2; the two-pass
scheme of the GPU-Huffman literature in PAPERS.md). The payload is cut at
byte boundaries into chunks of CHUNK_BYTES. The decoder state entering a
chunk is one small integer, the bit offset within the chunk where the first
fresh codeword starts, so:

* **pass 1 (speculative):** every (chunk, entry offset < E) pair is a lane;
  each lane walks its chunk from its offset and reports the exit offset into
  the next chunk and the number of symbols decoded;
* **compose (host, O(chunks)):** the exits chain the true entry offsets
  through the chunks; the counts at the true offsets prefix-sum into each
  chunk's first output position;
* **pass 2:** one lane per chunk decodes at its true offset and writes its
  symbols straight to their output positions.

The trie rides one flattened table: lr2[2*node + bit] is the child node, or
-(leaf_id)-1 when that child is a leaf. EOF semantics match the host walker:
a code cut by the end of the payload decodes nothing.

``walk`` is D2's wrapper, one kernel for both passes (``csrc/huffman_dev.cu``
``walk_kernel``): it checks its inputs and launches the kernel for CUDA
tensors, raising if the launch fails, or runs the plain version
``walk_ref`` (JAX's lockstep `_walk_body` as a loop of torch ops) for CPU
tensors. ``K`` (default TABLE_BITS) is the root table's width: with K >= 1
the walk reads a 2^K-entry table of the trie's first K levels (``table``,
or one it builds first; ``root_table`` on the card, ``table_kernel``, plain
version ``root_table_ref``) and takes one
lookup where it would take up to K bit steps from the root (plain model
``walk_table_model``); K = 0 walks one bit a step. Every K gives the same
outputs. ``root_table`` is the table's wrapper; ``walk.launches`` and
``root_table.launches`` count launches.

``decode_payload_device`` keeps JAX's fixed step budget (_STEPS) and
returns None, so that the caller uses the host decoder, in exactly JAX's
cases: a payload under CHUNK_BYTES or at or over _MAX_PAYLOAD_BYTES, a root
that is a leaf, no symbols, a pass-1 lane not frozen after _STEPS steps, a
true entry offset >= E before the last chunk, or fewer symbols in the
payload than asked for. ``declines`` counts those returns, ``decodes`` the
payloads it decoded.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .bitpack import _count_lock, count_launch, load_library, raise_launch

CHUNK_BYTES = 512
E = 32                      # entry offsets covered; > max code bits in practice
_STEPS = CHUNK_BYTES * 8 + E
# bit positions are int32 on the device: payloads of >= 2^31 bits (256 MB)
# go to the host decoder instead of wrapping chunk offsets
_MAX_PAYLOAD_BYTES = 1 << 28
# the root table's width on the card (PERF.md), and the widest the kernel
# takes: 2^14 int32 are 64 KB of shared memory a block
TABLE_BITS = 14
# a table entry packs a node id as v * 32 + bits; alphabets stay under 2^25
# symbols, so tries under 2^26 nodes
_MAX_TABLE_NODES = 1 << 26

declines = 0
decodes = 0


def _check(payload, lr2, starts, ends, total_bits, out_start, n_symbols):
    for name, t, dtype in (("payload", payload, torch.uint8),
                           ("lr2", lr2, torch.int32),
                           ("starts", starts, torch.int32),
                           ("ends", ends, torch.int32),
                           ("out_start", out_start, torch.int32)):
        if t is None:
            continue
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != payload.device:
            raise ValueError(f"{name} is on {t.device}, payload on "
                             f"{payload.device}")
    if payload.device.type not in ("cuda", "cpu"):
        raise ValueError(f"runs on cuda or cpu tensors, not {payload.device}")
    if starts.shape != ends.shape or (out_start is not None
                                      and out_start.shape != starts.shape):
        raise ValueError("starts, ends and out_start must have one length")
    if not 0 <= total_bits <= 8 * payload.numel() or total_bits >= 1 << 31:
        raise ValueError(f"total_bits {total_bits} does not fit the payload "
                         f"of {payload.numel()} bytes in int32 positions")
    if lr2.numel() < 2 or lr2.numel() % 2:
        raise ValueError("lr2 must hold two entries a node")
    if n_symbols < 0 or (n_symbols and out_start is None):
        raise ValueError("n_symbols needs out_start (pass 2)")


def walk(payload, lr2, starts, ends, total_bits: int, out_start=None,
         n_symbols: int = 0, n_steps: int = _STEPS, K: int = TABLE_BITS,
         table=None):
    """D2 over lanes starting at bit `starts` and stopping at `ends`.

    Returns (exits int32 [L] = exit bit - end, counts int32 [L], frozen:
    bool, ids int32 [n_symbols] or None). With `out_start` (pass 2) each
    lane's k-th symbol goes to ids[out_start + k], dropped at or past
    n_symbols. `K` in [0, TABLE_BITS]: the root table's width on the card;
    `table`, `root_table(lr2, K)` built once for several walks over one
    lr2, or None to build it here."""
    _check(payload, lr2, starts, ends, total_bits, out_start, n_symbols)
    if int(K) != K or not 0 <= K <= TABLE_BITS:
        raise ValueError(f"K must be an integer in [0, {TABLE_BITS}], "
                         f"got {K!r}")
    if table is not None and (
            not K or table.dtype != torch.int32
            or tuple(table.shape) != (1 << int(K),)
            or table.device != payload.device):
        raise ValueError(f"table must be int32 [2^K] on {payload.device} "
                         f"with K >= 1, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}, K = {K}")
    if payload.device.type == "cpu":
        return walk_ref(payload, lr2, starts, ends, total_bits, out_start,
                        n_symbols, n_steps)
    lib = load_library()
    dev = payload.device
    K = int(K)
    L = starts.numel()
    exits = torch.empty(L, dtype=torch.int32, device=dev)
    counts = torch.empty(L, dtype=torch.int32, device=dev)
    unfrozen = torch.zeros(1, dtype=torch.int32, device=dev)
    ids = (torch.zeros(n_symbols, dtype=torch.int32, device=dev)
           if out_start is not None else None)
    if K and table is None:
        table = root_table(lr2, K)
    if K and payload.data_ptr() % 4:
        payload = payload.clone()  # the table walk reads aligned words
    with torch.cuda.device(dev):
        rc = lib.huf_walk(
            payload.data_ptr(), lr2.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), L, total_bits, n_steps,
            None if out_start is None else out_start.data_ptr(),
            None if ids is None else ids.data_ptr(), n_symbols,
            exits.data_ptr(), counts.data_ptr(), unfrozen.data_ptr(), K,
            None if table is None else table.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise_launch(lib, "huf_walk", rc, f"{L} lanes")
    count_launch(walk)
    return exits, counts, int(unfrozen.item()) == 0, ids


walk.launches = 0


def root_table(lr2, K: int):
    """The root table of D2 on the card (`table_kernel`): int32 [2^K] for a
    CUDA lr2 of fewer than 2^26 nodes, 1 <= K <= TABLE_BITS; the plain version
    `root_table_ref` for a CPU one. `root_table.launches` counts launches."""
    if lr2.dtype != torch.int32 or lr2.dim() != 1 or lr2.numel() % 2:
        raise ValueError("lr2 must be int32 [2 * nodes]")
    if not lr2.is_contiguous():
        raise ValueError("lr2 must be contiguous")
    if int(K) != K or not 1 <= K <= TABLE_BITS:
        raise ValueError(f"K must be an integer in [1, {TABLE_BITS}], "
                         f"got {K!r}")
    if lr2.numel() // 2 >= _MAX_TABLE_NODES:
        raise ValueError(f"a root table holds node ids below "
                         f"{_MAX_TABLE_NODES}")
    if lr2.device.type == "cpu":
        return root_table_ref(lr2, int(K))
    if lr2.device.type != "cuda":
        raise ValueError(f"runs on cuda or cpu tensors, not {lr2.device}")
    lib = load_library()
    table = torch.empty(1 << int(K), dtype=torch.int32, device=lr2.device)
    with torch.cuda.device(lr2.device):
        rc = lib.huf_root_table(lr2.data_ptr(), table.data_ptr(), int(K),
                                torch.cuda.current_stream(lr2.device)
                                .cuda_stream)
    if rc != 0:
        raise_launch(lib, "huf_root_table", rc, f"K = {K}")
    count_launch(root_table)
    return table


root_table.launches = 0


def walk_ref(payload, lr2, starts, ends, total_bits: int, out_start=None,
             n_symbols: int = 0, n_steps: int = _STEPS):
    """The plain PyTorch version of D2 (any device): all lanes step in
    lockstep, one bit a step, for at most n_steps steps. A frozen lane
    never moves again, so the loop may stop once every lane is frozen."""
    pay = payload.long()
    lr = lr2.long()
    ends = ends.long()
    node = torch.zeros_like(ends)
    bitpos = starts.long()
    cnt = torch.zeros_like(ends)
    ids = (torch.zeros(n_symbols, dtype=torch.int32, device=payload.device)
           if out_start is not None else None)
    first = out_start.long() if out_start is not None else None
    last_byte = max(payload.numel() - 1, 0)

    def frozen_now():
        return ((node == 0) & (bitpos >= ends)) | (bitpos >= total_bits)

    for step in range(n_steps):
        frozen = frozen_now()
        if step % 32 == 0 and bool(frozen.all()):
            break
        act = ~frozen
        byte = pay[torch.clamp(bitpos >> 3, 0, last_byte)]
        v = lr[2 * node + ((byte >> (7 - (bitpos & 7))) & 1)]
        leaf = v < 0
        emit = leaf & act
        if ids is not None:
            tgt = first + cnt
            keep = emit & (tgt < n_symbols)
            ids[tgt[keep]] = (-v[keep] - 1).to(torch.int32)
        node = torch.where(act, torch.where(leaf, 0, v), node)
        cnt = cnt + emit.long()
        bitpos = bitpos + act.long()
    return ((bitpos - ends).to(torch.int32), cnt.to(torch.int32),
            bool(frozen_now().all()), ids)


def root_table_ref(lr2, K: int):
    """The plain version of the card's root table (`table_kernel`): entry e
    of int32 [2^K] is the walk of e's K bits (MSB first) from the root, as
    v * 32 + n: back at the root after n <= K bits (v < 0 through leaf
    -v-1, v == 0 through a missing child), or at node v > 0 after K."""
    lr = lr2.long()
    e = torch.arange(1 << K, dtype=torch.int64, device=lr2.device)
    node = torch.zeros_like(e)
    out = torch.zeros_like(e)
    done = torch.zeros_like(e, dtype=torch.bool)
    for i in range(K):
        v = lr[2 * node + ((e >> (K - 1 - i)) & 1)]
        stop = ~done & (v <= 0)
        out = torch.where(stop, v * 32 + i + 1, out)
        done |= stop
        node = torch.where(done, 0, v)
    return torch.where(done, out, node * 32 + K).to(torch.int32)


def walk_table_model(payload, lr2, starts, ends, total_bits: int,
                     out_start=None, n_symbols: int = 0,
                     n_steps: int = _STEPS, K: int = TABLE_BITS):
    """A plain model of the card's table walk (`walk_kernel` with K >= 1),
    for the tests: lanes in lockstep, each taking a round either one lookup
    in `root_table_ref` (at the root, with K payload bits and K steps of the
    budget left) or one bit step. Returns what `walk_ref` returns; K = 0 is
    `walk_ref`."""
    if K == 0:
        return walk_ref(payload, lr2, starts, ends, total_bits, out_start,
                        n_symbols, n_steps)
    table = root_table_ref(lr2, K).long()
    pay = payload.long()
    lr = lr2.long()
    ends = ends.long()
    node = torch.zeros_like(ends)
    bitpos = starts.long()
    cnt = torch.zeros_like(ends)
    steps = torch.zeros_like(ends)
    ids = (torch.zeros(n_symbols, dtype=torch.int32, device=payload.device)
           if out_start is not None else None)
    first = out_start.long() if out_start is not None else None
    n_bytes = (total_bits + 7) // 8

    def bits_at(pos, need):
        """The `need` <= 14 bits at `pos`, from the 3 bytes that hold them;
        bytes past the payload read as 0."""
        word = torch.zeros_like(pos)
        for i in range(3):
            at = (pos >> 3) + i
            byte = pay[at.clamp(0, max(payload.numel() - 1, 0))]
            word = (word << 8) | torch.where(at < n_bytes, byte, 0)
        return (word >> (24 - (pos & 7) - need)) & ((1 << need) - 1)

    def frozen_now():
        return ((node == 0) & (bitpos >= ends)) | (bitpos >= total_bits)

    while True:
        act = ~frozen_now() & (steps < n_steps)
        if not bool(act.any()):
            break
        use = (act & (node == 0) & (bitpos + K <= total_bits)
               & (steps + K <= n_steps))
        e = table[bits_at(bitpos, K)]
        v = torch.where(use, e >> 5, lr[2 * node + bits_at(bitpos, 1)])
        n = torch.where(use, e & 31, 1)
        leaf = v < 0
        emit = leaf & act
        if ids is not None:
            tgt = first + cnt
            keep = emit & (tgt < n_symbols)
            ids[tgt[keep]] = (-v[keep] - 1).to(torch.int32)
        node = torch.where(act, torch.where(leaf, 0, v), node)
        cnt = cnt + emit.long()
        bitpos = bitpos + torch.where(act, n, 0)
        steps = steps + torch.where(act, n, 0)
    return ((bitpos - ends).to(torch.int32), cnt.to(torch.int32),
            bool(frozen_now().all()), ids)


def _lr2(left: np.ndarray, right: np.ndarray, symbol: np.ndarray) -> np.ndarray:
    n = left.size
    lr2 = np.zeros(2 * n, np.int32)
    for b, child in ((0, left), (1, right)):
        c = child.astype(np.int64)
        val = np.where(c >= 0, np.where(symbol[np.clip(c, 0, n - 1)] >= 0,
                                        -symbol[np.clip(c, 0, n - 1)] - 1, c), 0)
        lr2[b::2] = val
    return lr2


def _decline():
    global declines
    with _count_lock:
        declines += 1
    return None


def _decoded(ids):
    global decodes
    with _count_lock:
        decodes += 1
    return ids


def chunk_bounds(n_bytes: int):
    """Each chunk's first and end bit, int32 [C], for a payload of n_bytes:
    built in int64 and clamped to the payload's bits before the cast, as
    JAX builds them, so the last chunk's end cannot wrap below 2^31 bits."""
    C = -(-n_bytes // CHUNK_BYTES)
    starts = np.arange(C, dtype=np.int64) * CHUNK_BYTES * 8
    ends = np.minimum(starts + CHUNK_BYTES * 8, n_bytes * 8)
    return starts.astype(np.int32), ends.astype(np.int32)


def lanes(pay: np.ndarray, left, right, symbol, device):
    """The operands of both passes on `device` for a uint8 payload of at
    least one byte: (payload uint8, lr2 int32, pass-1 starts and ends int32
    [C*E], chunk starts and ends int32 [C], total_bits)."""
    total_bits = pay.size * 8
    lr2 = torch.from_numpy(_lr2(left, right, symbol)).to(device)
    pay_t = torch.from_numpy(pay.copy()).to(device)
    chunk, chunk_ends = (torch.from_numpy(a).to(device)
                         for a in chunk_bounds(pay.size))
    # pass 1: (C, E) speculative lanes, flattened chunk-major
    starts1 = (chunk[:, None] + torch.arange(E, dtype=torch.int32,
                                             device=device)[None, :]).reshape(-1)
    ends1 = chunk_ends.repeat_interleave(E)
    return pay_t, lr2, starts1, ends1, chunk, chunk_ends, total_bits


def compose(exits, cnts, n_symbols: int):
    """Chain pass 1's (C*E) exits into each chunk's true entry offset and
    first output position (host, O(C)): (offs, out_start) int32 [C], or
    None where the reference declines (a code deeper than E crossed a chunk
    boundary before the last chunk, or too few symbols)."""
    exits = exits.reshape(-1, E).cpu().numpy()
    cnts = cnts.reshape(-1, E).cpu().numpy()
    C = exits.shape[0]
    e = 0
    offs = np.empty(C, np.int64)
    counts = np.empty(C, np.int64)
    for i in range(C):
        offs[i] = e
        counts[i] = cnts[i, e]
        e = int(exits[i, e])
        if e >= E or e < 0:
            if i + 1 < C:
                return None  # a code deeper than E crossed this boundary
            e = 0
    if int(counts.sum()) < n_symbols:
        # stream too short for the requested symbol count: the host path
        # raises a clean error; let it
        return None
    out_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return offs.astype(np.int32), out_start.astype(np.int32)


def decode_payload_device(payload, left, right, symbol, n_symbols: int,
                          device="cuda") -> np.ndarray | None:
    """Decode symbol ids on `device` with D2; None = the caller should use
    the host decoder (see the module note for exactly when)."""
    dev = resolve_device(device)
    pay = np.frombuffer(bytes(payload), dtype=np.uint8)
    if (pay.size < CHUNK_BYTES or pay.size >= _MAX_PAYLOAD_BYTES
            or symbol[0] >= 0 or n_symbols == 0):
        return _decline()
    pay, lr2, starts1, ends1, chunk, chunk_ends, total_bits = lanes(
        pay, left, right, symbol, dev)
    table = root_table(lr2, TABLE_BITS)  # one table for both passes
    exits, cnts, ok, _ = walk(pay, lr2, starts1, ends1, total_bits,
                              table=table)
    if not ok:
        return _decline()
    composed = compose(exits, cnts, n_symbols)
    if composed is None:
        return _decline()
    offs, out_start = (torch.from_numpy(a).to(dev) for a in composed)
    _, _, _, ids = walk(pay, lr2, chunk + offs, chunk_ends, total_bits,
                        out_start=out_start, n_symbols=int(n_symbols),
                        table=table)
    return _decoded(ids.cpu().numpy())

"""A zip(back) match finder as torch ops on the card, against the C engine.

Port of ``scripts/experiments/zipback_tpu_matchfinder.py``. zip(back) is
the largest host cost on record (38% of the midtex sweep's wall time on
the card's host, ``PERF.md`` §5). The original measured on a TPU what a
device match finder would cost; this asks the same of the card, against
the production C engine on the same framed stream (``Zip("back")``'s raw
stream of a ``bench.synth_image``, seed 2024):

1. the C engine's whole encode (its match finding is parse-independent, so
   a device finder must beat the engine less its emission);
2. the transfers a device finder cannot avoid: the stream up, a
   per-position (len u16, back u16) table down;
3. a device matcher (``device_matcher``): 6-byte keys from shifted views,
   one stable sort, the K nearest same-key predecessors in sorted order,
   the match extended by gathers up to T bytes. K and T are lower bounds
   of the cost of the reference's semantics, which need every window
   candidate and extension up to 32767 bytes. It is validated bit for bit
   against ``numpy_matcher``, the original's numpy replica, copied;
4. the floor of the gather-free alternative: 13 prefix-doubling sorts.

    python -m cniic_tpu_torch.experiments.zipback_matchfinder
        [--device=cuda]

Each time is the median of three, ended by a synchronize, beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import native
from ..bench import SEED, device_label, synth_image
from ..codecs.zipc import Zip
from . import open_device, sync


def synth_stream(side: int) -> np.ndarray:
    img = synth_image(np.random.default_rng(SEED), side, side)
    return Zip("back", device="cpu")._raw_stream(img)


def timed(fn, dev, reps: int = 3):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def device_matcher(stream, K: int, T: int):
    """Per position of a uint8 stream (a tensor on any device): the longest
    match among its K nearest same-6-byte-key predecessors in sorted order
    (capped at T bytes past the key), as (len int64[n], candidate int64[n],
    -1 where none): the semantics of ``numpy_matcher``."""
    dev = stream.device
    n = stream.numel()
    s = stream.to(torch.int64)

    def byte(i):  # contiguous shifted view; positions >= n-i wrap (masked)
        return torch.roll(s, -i)

    lo = byte(0) | (byte(1) << 8) | (byte(2) << 16) | (byte(3) << 24)
    hi = byte(4) | (byte(5) << 8)
    # one key, (lo, hi) in order; stable keeps positions ascending in a group
    key_s, pos_s = torch.sort((lo << 16) | hi, stable=True)
    slot = torch.arange(n, dtype=torch.int64, device=dev)
    tail = torch.arange(T, dtype=torch.int64, device=dev)
    best_len = torch.zeros(n, dtype=torch.int64, device=dev)
    best_q = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for j in range(1, K + 1):  # j-th nearest predecessor slot
        q = torch.roll(pos_s, j)
        valid = ((torch.roll(key_s, j) == key_s) & (slot >= j)
                 & (q <= pos_s - 6) & (q >= pos_s - 65535))
        at = pos_s[:, None] + 6 + tail[None, :]
        a = stream[at.clamp(max=n - 1)]
        b = stream[(q[:, None] + 6 + tail[None, :]).clamp(max=n - 1)]
        neq = (a != b) | (at >= n)
        ext = torch.where(neq.any(dim=1), neq.to(torch.uint8).argmax(dim=1),
                          T)
        mlen = torch.minimum(6 + ext, (pos_s - q).clamp(max=32767))
        mlen = torch.where(valid, torch.minimum(mlen, n - pos_s), 0)
        # ascending j prefers the nearest among equal lengths
        better = mlen > best_len
        best_len = torch.where(better, mlen, best_len)
        best_q = torch.where(better, q, best_q)
    out_len = torch.zeros_like(best_len).scatter_(0, pos_s, best_len)
    out_q = torch.zeros_like(best_q).scatter_(0, pos_s, best_q)
    return out_len, out_q


def numpy_matcher(stream: np.ndarray, K: int, T: int):
    """Replica of the device matcher's exact (K, T)-capped semantics (copy
    of the original's)."""
    n = stream.shape[0]
    s32 = stream.astype(np.uint32)

    def byte(i):
        return np.roll(s32, -i)

    lo = byte(0) | (byte(1) << 8) | (byte(2) << 16) | (byte(3) << 24)
    hi = byte(4) | (byte(5) << 8)
    order = np.lexsort((np.arange(n), hi, lo))
    lo_s, hi_s, pos_s = lo[order], hi[order], np.arange(n)[order]
    best_len = np.zeros(n, np.int64)
    best_q = np.full(n, -1, np.int64)
    for j in range(1, K + 1):
        q = np.roll(pos_s, j)
        same = (np.roll(lo_s, j) == lo_s) & (np.roll(hi_s, j) == hi_s)
        same &= np.arange(n) >= j
        valid = same & (q <= pos_s - 6) & (q >= pos_s - 65535)
        mlen = np.zeros(n, np.int64)
        for i in np.where(valid)[0]:
            p, qq = int(pos_s[i]), int(q[i])
            ext = 0
            while (ext < T and p + 6 + ext < n
                   and stream[p + 6 + ext] == stream[qq + 6 + ext]):
                ext += 1
            mlen[i] = min(6 + ext, p - qq, 32767, n - p)
        better = mlen > best_len
        best_len = np.where(better, mlen, best_len)
        best_q = np.where(better, q, best_q)
    out_len = np.zeros(n, np.int64)
    out_q = np.zeros(n, np.int64)
    out_len[pos_s] = best_len
    out_q[pos_s] = best_q
    return out_len, out_q


def sort13(r, i):
    """The suffix-rank floor: 13 stable sorts on (rank, next rank) keys."""
    for _ in range(13):
        key, perm = torch.sort((r << 32) | torch.roll(r, -1), stable=True)
        r, i = key >> 32, i[perm]
    return r, i


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    if dev is None:
        return 1
    who = device_label(dev.type)
    small = np.random.default_rng(7).integers(0, 4, 4096).astype(np.uint8)
    dl, dq = device_matcher(torch.from_numpy(small).to(dev), 2, 16)
    nl, nq = numpy_matcher(small, 2, 16)
    if not (np.array_equal(dl.cpu().numpy(), nl)
            and np.array_equal(dq.cpu().numpy(), nq)):
        print("validation: device matcher != numpy replica", file=sys.stderr)
        return 1
    print(f"validation: {dev} matcher == numpy replica (K=2, T=16)",
          flush=True)

    for side in (512, 1024):
        stream = synth_stream(side)
        n = stream.size
        print(f"\n--- {side}x{side} framed stream: {n / 1e6:.2f} MB, {who} ---")
        t_c, _ = timed(lambda: native.zip_back_encode(stream.tobytes()), dev)
        print(f"C engine total: {t_c:.4f} s ({side * side / 1e6 / t_c:.2f} "
              f"MP/s, {n / 1e6 / t_c:.1f} MB/s)")
        up_t, dev_stream = timed(lambda: torch.from_numpy(stream).to(dev),
                                 dev)
        table = torch.zeros((2, n), dtype=torch.int16, device=dev)
        dn_t, _ = timed(lambda: (table + 1).cpu(), dev)
        print(f"transfers: stream up {up_t:.4f} s, match table down "
              f"{dn_t:.4f} s (sum {(up_t + dn_t) / t_c * 100:.0f}% of C "
              "total)")
        for K, T in ((1, 8), (2, 16)):
            device_matcher(dev_stream, K, T)  # warm
            t_dev, _ = timed(lambda K=K, T=T: device_matcher(dev_stream, K, T),
                             dev)
            print(f"device matcher K={K} T={T}: {t_dev:.4f} s "
                  f"({t_dev / t_c:.2f}x C total; full semantics need all "
                  "window candidates + uncapped extension)")
        r0 = dev_stream.to(torch.int64)
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        sort13(r0, idx)  # warm
        t_sort, _ = timed(lambda: sort13(r0, idx), dev)
        print(f"13 prefix-doubling sorts (suffix-rank floor): {t_sort:.4f} s "
              f"({t_sort / t_c:.2f}x C total)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Crafted approximate-RLE streams shared by the port's CPU and CUDA tests
(imports neither jax nor `cniic_tpu`)."""

import numpy as np

# (allow, count c, t0, t1, t2): after a run of c pixels with channel sums S,
# the next pixel x gives t = S - c*x with sum t^2 within f32 rounding of
# (allow*c)^2, where fma(t2, t2, fma(t0, t0, t1*t1)) rejects x but the
# unfused (t0*t0 + t1*t1) + t2*t2 accepts it
FMA_CASES = [
    (32, 237, -203, 1909, 7337), (32, 246, 733, -3127, 7187),
    (32, 179, 261, -1884, 5403), (64, 98, -2577, -763, 5667),
    (64, 246, -6038, -13622, 5085), (64, 86, 4459, 131, 3224),
]

# a run (3,3,3),(3,3,2),(4,4,3) [sums (10,10,8), count 3], then (2,2,2):
# dist2 = 36 == (allow*c)^2 at allow 2 with every average inexact in f64,
# the tie K2 must flag
TIE = np.array([[3, 3, 3], [3, 3, 2], [4, 4, 3], [2, 2, 2]], np.uint8)
FLAT = (3, 3, 3)  # the colour of TIE's first pixel
SPEC_TIE = 448    # a seam at chunks 1, 2, 7, 32 and 64, not a true run start


def make_batch(rng):
    """tests/test_approx_rle_pallas.py's batch: walks, a 1-pixel stream, a
    capped length and one random stream."""
    B, L = 6, 3000
    lens = np.array([3000, 2999, 1, 700, 255 * 4, 2500], np.int32)
    scans = np.zeros((B, L, 3), np.uint8)
    for j in range(B):
        base = rng.integers(0, 25, 3)
        walk = rng.integers(-2, 3, (int(lens[j]), 3)).cumsum(0)
        scans[j, : lens[j]] = np.clip(base + walk, 0, 255)
    scans[5, : lens[5]] = rng.integers(0, 256, (int(lens[5]), 3))
    return scans, lens


def run_then_pixel(c, t, rng, tail=40):
    """A run of c pixels whose sums give exactly `t` against the pixel that
    follows it, then `tail` random pixels."""
    t = np.asarray(t)
    q = np.floor_divide(t, c)
    u = 128 + (q + 1) // 2
    x = u - q
    run = np.tile(u, (c, 1))
    for ch in range(3):
        run[: t[ch] - c * q[ch], ch] += 1
    assert (run.sum(0) - c * x == t).all()
    return np.concatenate([run, x[None], rng.integers(0, 256, (tail, 3))]
                          ).astype(np.uint8)


def fma_batch(allow, rng):
    """(scans, lens, first run counts) of the FMA_CASES at `allow`."""
    streams = [(c, run_then_pixel(c, t, rng))
               for a, c, *t in FMA_CASES if a == allow]
    L = max(len(s) for _, s in streams)
    scans = np.zeros((len(streams), L, 3), np.uint8)
    for i, (_, s) in enumerate(streams):
        scans[i, : len(s)] = s
    return scans, np.array([len(s) for _, s in streams]), [c for c, _ in streams]


def seam_batch(chunk, rng):
    """Eight streams for K3's chunk schedule at `chunk` (taken as at most
    256): a flat stream of 3 * 255 + 17 pixels, whose cap-closed runs start
    at other offsets than the chunks and so never sync; a flat stream with
    one edge; a run closed by the cap exactly at a seam; and walks of
    lengths 0, 1, 3c, 3c - 1 and 3c + 1. Returns (scans, lens)."""
    c = min(chunk, 256)
    flat = np.full((3 * 255 + 17, 3), 9)
    edge = flat.copy()
    edge[400:] = 200
    seam = -(-300 // c) * c  # a seam at or past position 300
    capped = rng.integers(0, 256, (seam + 200, 3))
    capped[seam - 255: seam] = 77  # after a random pixel: a run of 255
    walks = [np.clip(rng.integers(0, 25, 3)
                     + rng.integers(-2, 3, (n, 3)).cumsum(0), 0, 255)
             for n in (0, 1, 3 * c, 3 * c - 1, 3 * c + 1)]
    streams = [flat, edge, capped] + walks
    L = max(len(s) for s in streams)
    scans = np.zeros((len(streams), L, 3), np.uint8)
    for i, s in enumerate(streams):
        scans[i, : len(s)] = s
    return scans, np.array([len(s) for s in streams])


def tie_batch(rng):
    """Four streams for K2's chunk schedule at allow 2. (i) 510 pixels of
    FLAT (two runs capped at 255, so the true walk starts a run at 510),
    then TIE from 510: the true walk meets the tie at 513, a walk that
    starts fresh at the chunk holding 513 does not, and the seams before it
    never sync. (ii) FLAT with TIE at SPEC_TIE: a walk that starts fresh at
    that seam meets the tie at SPEC_TIE + 3; the true walk, deep in a run of
    FLAT, accepts it with no tie. Then TIE after a far colour (every walk
    starts a run at it: a tie at a sync point) and a flat stream, whose runs
    capped at 255 never start where a chunk does. Returns (scans, lens)."""
    rewalked = np.full((700, 3), FLAT)
    rewalked[510:514] = TIE
    rewalked[514:] = rng.integers(0, 256, (186, 3))
    speculative = np.full((700, 3), FLAT)
    speculative[SPEC_TIE:SPEC_TIE + 4] = TIE
    synced = rng.integers(150, 256, (700, 3))
    synced[300:304] = TIE
    flat = np.full((700, 3), 9)
    scans = np.stack([rewalked, speculative, synced, flat]).astype(np.uint8)
    return scans, np.full(4, 700)

"""Randomized encode-side campaign over all nine families, on a device.

Port of ``scripts/experiments/roundtrip_campaign.py``: the same SPECS, the
same random shapes (1-3 pixel strips included) and content classes
(``_rand_shape`` and ``_rand_image`` are copies), the same per-trial seeds
and the same five contracts:

1. ``encode`` succeeds or rejects with the ValueError family (or the
   k-means floor's AssertionError); anything else is a finding.
2. ``encode_batch`` lanes are bit-identical to per-image ``encode``, and a
   lane fails exactly where the per-image call fails.
3. Lossless codecs round-trip exactly; lossy decodes have the image's shape
   and dtype and a finite MSE, and a voronoi(k) stream is 16 + 19k bytes.
4. ``decode_batch`` lanes equal per-image ``decode``, and
   ``decode_mse_batch`` (voronoi) agrees with decode + error (sampled:
   seeds divisible by 7).
5. Re-encoding the same batch is deterministic (sampled likewise).

    python -m cniic_tpu_torch.experiments.roundtrip_campaign
        [--device=cuda|cpu] [--seed=S0] [--trials=N] [--gates=k2,k3,d1,d2]
        [--out=findings] [seconds]

Trial i uses seed S0 + i (S0 = 0 by default), as the original's; with
``--trials=N`` the run is seeds S0+1..S0+N, else as many as fit in
``seconds`` (600). ``--gates`` sets env gates for the whole run (set and
restored): ``k2`` CNIIC_CHUNKED_RLE (K2 in hilbert(rle(3))'s ``encode``),
``k3`` CNIIC_PALLAS_RLE (K3 in its ``encode_batch``), ``d1``
CNIIC_DEVICE_BITPACK (D1 packs hufman, delta and cluster-colors) and ``d2``
CNIIC_DEVICE_HUF_DECODE (D2 decodes them in the round trips).

Under ``k3``, contract 2 is held differently, by design: K3 is JAX's f32
form of the approximate-RLE recurrence, whose streams equal the batch
route's, not always the exact engine's (``codecs/hilbertc.py``). So a
hilbert(rle(d)) batch is held byte for byte against the same batch through
K3's plain version (``device="cpu"``) instead of against ``encode``; on a
CPU run that is the same route twice. Every other contract, and contract 2
under the other gates, stays as it is.

A violation writes ``<out>/roundtrip_finding_<tag>_<seed>.json`` (seed,
shapes, spec, detail) and the run exits 1. The last line is ``campaign
done: {json}``: trials, rejects and findings per spec, each spec's
``streams_sha256`` (sha256 over every trial's per-image streams, each as
its length and bytes, a rejected one as b"x") and ``batch_sha256`` (the
same over the batch lanes), and the kernels' launches over the run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

from ..codecs import from_spec
from ..ops import approx_rle, bitpack, hufdec, kmeans_kernel
from ..runner import compute_error
from . import env_gates, open_device

SPECS = ["hufman", "delta", "hilbert(rle)", "hilbert(rle(3))",
         "hilbert(zip)", "zip(dict)", "zip(back)",
         "cluster-colors(4)", "cluster-colors(16)",
         "voronoi(4)", "voronoi(32)"]
# the legitimate per-lane rejection family: infeasibility ValueErrors plus
# the k-means active-cluster floor, which raises AssertionError in raise
# mode and stores it in collect-mode lanes (ops/kmeans.py _check_active)
ALLOWED = (ValueError, AssertionError)
GATES = {"k2": "CNIIC_CHUNKED_RLE", "k3": "CNIIC_PALLAS_RLE",
         "d1": "CNIIC_DEVICE_BITPACK", "d2": "CNIIC_DEVICE_HUF_DECODE"}
COUNTERS = {"K1": kmeans_kernel.assign_stats, "K2": approx_rle.wide_records,
            "K3": approx_rle.batch_records, "D1": bitpack.pack_words,
            "D2": hufdec.walk}


def _rand_shape(rng) -> tuple[int, int]:
    """Copy of the original's shapes."""
    cls = rng.integers(0, 4)
    if cls == 0:  # thin strips (curve/framing edge cases)
        a = int(rng.integers(1, 4))
        b = int(rng.integers(1, 200))
        return (a, b) if rng.integers(0, 2) else (b, a)
    if cls == 1:  # tiny
        return int(rng.integers(1, 12)), int(rng.integers(1, 12))
    if cls == 2:  # small odd
        return int(rng.integers(5, 64)), int(rng.integers(5, 64))
    return int(rng.integers(32, 180)), int(rng.integers(32, 180))


def _rand_image(rng) -> np.ndarray:
    """Copy of the original's content classes."""
    h, w = _rand_shape(rng)
    cls = rng.integers(0, 7)
    if cls == 0:  # solid
        return np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    if cls == 1:  # pure noise
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if cls == 2:  # limited palette (2..300 colors)
        p = int(rng.integers(2, 300))
        pal = rng.integers(0, 256, (p, 3)).astype(np.uint8)
        return pal[rng.integers(0, p, (h, w))]
    if cls == 3:  # horizontal gradient + channel offsets
        g = np.linspace(0, 255, w, dtype=np.float32)
        img = np.stack([(g + o) % 256 for o in rng.integers(0, 256, 3)],
                       axis=-1)
        return np.broadcast_to(img.astype(np.uint8), (h, w, 3)).copy()
    if cls == 4:  # vertical stripes of random period
        period = int(rng.integers(1, max(2, w // 2 + 1)))
        pal = rng.integers(0, 256, (period, 3)).astype(np.uint8)
        return pal[(np.arange(w) % period)][None].repeat(h, axis=0)
    if cls == 5:  # blocks (RLE/LZ-friendly)
        bh, bw = int(rng.integers(1, 9)), int(rng.integers(1, 9))
        gh, gw = -(-h // bh), -(-w // bw)
        pal = rng.integers(0, 256, (gh, gw, 3)).astype(np.uint8)
        return pal.repeat(bh, axis=0).repeat(bw, axis=1)[:h, :w]
    # smooth noise: low-res noise upsampled (delta-friendly)
    sh, sw = max(1, h // 8), max(1, w // 8)
    base = rng.integers(0, 256, (sh, sw, 3)).astype(np.uint8)
    return base.repeat(-(-h // sh), axis=0).repeat(-(-w // sw), axis=1)[:h, :w]


def trial_images(seed: int) -> list:
    """The images of the trial with this seed (1 to 5 of them)."""
    rng = np.random.default_rng(seed)
    return [_rand_image(rng) for _ in range(int(rng.integers(1, 6)))]


def digest(h, streams) -> None:
    """Feed streams to a sha256: each as its length and bytes, a rejected
    one (None or an exception in its place) as b"x"."""
    for s in streams:
        if isinstance(s, bytes):
            h.update(b"%d:" % len(s) + s)
        else:
            h.update(b"x")


class Campaign:
    """The five contracts over trials; findings go to `out_dir`."""

    def __init__(self, dev, gate_names=(), out_dir="findings"):
        self.codecs = [(s, from_spec(s, device=dev)) for s in SPECS]
        # under k3 a hilbert(rle(d)) batch is held against K3's plain route
        self.batch_refs = {
            s: from_spec(s, device="cpu") for s, c in self.codecs
            if "k3" in gate_names and getattr(c, "mode", None) == "rle"
            and c.allow > 0}
        self.out_dir = out_dir
        self.trials = {s: 0 for s in SPECS}
        self.rejects = {s: 0 for s in SPECS}
        self.hashes = {s: hashlib.sha256() for s in SPECS}
        self.batch_hashes = {s: hashlib.sha256() for s in SPECS}
        self.findings = 0

    def fail(self, tag, spec, seed, imgs, detail) -> None:
        self.findings += 1
        repro = {"tag": tag, "spec": spec, "seed": int(seed),
                 "shapes": [list(im.shape) for im in imgs], "detail": detail}
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f"roundtrip_finding_{tag}_{seed}.json")
        with open(path, "w") as fh:
            json.dump(repro, fh, indent=1)
        print(f"FINDING [{tag}] {spec} seed={seed}: {detail} -> {path}",
              flush=True)

    def run(self, seed: int) -> None:
        imgs = trial_images(seed)
        for spec, codec in self.codecs:
            self.trials[spec] += 1
            self._one(spec, codec, seed, imgs)

    def _one(self, spec, codec, seed, imgs) -> None:
        fail = self.fail
        # per-image encodes (the contract's reference side)
        singles = []
        for im in imgs:
            try:
                singles.append(codec.encode(im))
            except ALLOWED:
                singles.append(None)
                self.rejects[spec] += 1
            except Exception as e:  # noqa: BLE001
                fail("encode_raise", spec, seed, imgs, repr(e))
                singles.append(None)
        # batch must match lane-for-lane
        try:
            blobs = codec.encode_batch(imgs)
        except ALLOWED:
            blobs = None
            if any(s is not None for s in singles):
                fail("batch_reject_single_ok", spec, seed, imgs,
                     "encode_batch rejected a batch with encodable lanes")
        except Exception as e:  # noqa: BLE001
            blobs = None
            fail("batch_raise", spec, seed, imgs, repr(e))
        digest(self.hashes[spec], singles)
        if blobs is not None:
            digest(self.batch_hashes[spec], blobs)
            ref = self.batch_refs.get(spec)
            want = singles if ref is None else ref.encode_batch(imgs)
            for i, (s, b, r) in enumerate(zip(singles, blobs, want)):
                if isinstance(b, Exception):
                    if not isinstance(b, ALLOWED):
                        fail("lane_exc_type", spec, seed, imgs,
                             f"lane {i}: {b!r}")
                    elif s is not None:
                        fail("lane_exc_single_ok", spec, seed, imgs,
                             f"lane {i} failed but encode() succeeded")
                elif s is None:
                    fail("lane_ok_single_rej", spec, seed, imgs,
                         f"lane {i} succeeded but encode() rejected")
                elif r != b:
                    fail("lane_bytes", spec, seed, imgs,
                         f"lane {i}: batch != "
                         f"{'single' if ref is None else 'plain K3 route'} "
                         f"({len(b)} vs {len(r)} B)")
        # round-trip every successful stream
        for i, (im, s) in enumerate(zip(imgs, singles)):
            if s is None:
                continue
            if spec.startswith("voronoi("):
                k = int(spec[8:-1])
                if len(s) != 16 + 19 * k:
                    fail("voronoi_size", spec, seed, imgs,
                         f"lane {i}: {len(s)} != {16 + 19 * k} B")
            try:
                dec = codec.decode(s)
            except Exception as e:  # noqa: BLE001
                fail("decode_raise", spec, seed, imgs, f"lane {i}: {e!r}")
                continue
            if dec.shape != im.shape or dec.dtype != np.uint8:
                fail("decode_shape", spec, seed, imgs,
                     f"lane {i}: {dec.shape} {dec.dtype}")
            elif codec.is_lossless and not np.array_equal(dec, im):
                fail("roundtrip", spec, seed, imgs,
                     f"lane {i}: lossless mismatch")
            elif not np.isfinite(compute_error(im, dec)):
                fail("mse_nan", spec, seed, imgs, f"lane {i}")
        # fused decode+MSE agreement + encode determinism (sampled)
        if blobs is None or seed % 7:
            return
        ok = [i for i, b in enumerate(blobs) if not isinstance(b, Exception)]
        if ok:
            decs = codec.decode_batch([blobs[i] for i in ok])
            for j, i in enumerate(ok):
                if not np.array_equal(decs[j], codec.decode(blobs[i])):
                    fail("decode_batch_lane", spec, seed, imgs,
                         f"lane {i}: batch decode != single decode")
        fused = getattr(codec, "decode_mse_batch", None)
        if fused is not None and ok:
            errs, _ = fused([blobs[i] for i in ok], [imgs[i] for i in ok])
            for j, i in enumerate(ok):
                ref = compute_error(imgs[i], codec.decode(blobs[i]))
                if abs(float(errs[j]) - ref) > 1e-6 * max(ref, 1.0):
                    fail("fused_mse", spec, seed, imgs,
                         f"lane {i}: {float(errs[j])} vs {ref}")
        blobs2 = codec.encode_batch(imgs)
        for i in ok:
            if isinstance(blobs2[i], Exception) or blobs2[i] != blobs[i]:
                fail("nondeterminism", spec, seed, imgs,
                     f"lane {i}: re-encode differs")

    def summary(self, launches) -> dict:
        return {"trials": self.trials, "rejects": self.rejects,
                "findings": self.findings,
                "streams_sha256": {s: h.hexdigest()
                                   for s, h in self.hashes.items()},
                "batch_sha256": {s: h.hexdigest()
                                 for s, h in self.batch_hashes.items()},
                "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seconds", nargs="?", type=float, default=600.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed0")
    ap.add_argument("--trials", type=int, default=0)
    ap.add_argument("--gates", default="",
                    help=f"comma-separated, of {','.join(GATES)}")
    ap.add_argument("--out", default="findings")
    args = ap.parse_args(argv)
    names = [g for g in args.gates.split(",") if g]
    unknown = sorted(set(names) - set(GATES))
    if unknown:
        print(f"unknown gates {unknown} (known: {','.join(GATES)})",
              file=sys.stderr)
        return 1
    dev = open_device(args.device)
    if dev is None:
        return 1
    print(f"seed0 {args.seed}, gates {','.join(names) or 'none'}, device "
          f"{dev}", flush=True)
    before = {n: c.launches for n, c in COUNTERS.items()}
    with env_gates([GATES[n] for n in names]):
        camp = Campaign(dev, names, args.out)
        t_end = time.perf_counter() + args.seconds
        seed = args.seed
        while (seed - args.seed < args.trials if args.trials
               else time.perf_counter() < t_end):
            seed += 1
            camp.run(seed)
            if seed % 25 == 0:
                print(f"seed {seed}: {sum(camp.trials.values())} trials, "
                      f"{sum(camp.rejects.values())} rejects, "
                      f"{camp.findings} finding(s)", flush=True)
    launches = {n: c.launches - before[n] for n, c in COUNTERS.items()}
    print("campaign done: " + json.dumps(camp.summary(launches)), flush=True)
    return 1 if camp.findings else 0


if __name__ == "__main__":
    sys.exit(main())

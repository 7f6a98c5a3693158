"""Randomized fuzz campaign over the nine decode paths, on an explicit device.

Port of ``scripts/experiments/fuzz_campaign.py``: the same nine families,
the same source images and the same six mutation kinds (``source_images``
and ``mutate`` are copies), and the same contract: decode succeeds with a
plausible uint8 image (at most 2^27 pixels) or raises the ValueError
family. Anything else is a finding: the blob is written to
``<out>/fuzz_finding_<family>_<seed>_<trial>.bin`` and the run exits 1.

    python -m cniic_tpu_torch.experiments.fuzz_campaign [--device=cuda|cpu]
        [--seed=N] [--trials=N] [--gates] [--against=cpu] [--out=findings]
        [seconds_per_family]

* ``--trials=N``: N mutated streams a family, so that a seed replays a run
  exactly; without it each family runs for ``seconds_per_family`` (60).
* ``--seed``: the generator's seed. Without one the run draws a seed from
  the OS, as the original always did; every run prints its seed first.
* ``--gates``: after the nine families, hufman and delta again under
  CNIIC_DEVICE_HUF_DECODE=1 (set and restored around them), so that
  mutated payloads reach D2 (``ops/hufdec.py``: ``walk_kernel`` on the
  card, ``walk_ref`` on the CPU). D2 declines payloads under
  ``hufdec.CHUNK_BYTES``, which the original's small sources are, so these
  two draw larger half-noise sources (``GATED_SHAPES``). Their summary
  counts the payloads D2 decoded (``d2_decodes``), those it declined and,
  on the card, ``walk_kernel``'s launches.
* ``--against=cpu``: every blob is decoded on the CPU as well (the plain
  versions, under the same gate), and a different outcome (one side
  raised, or the pixels differ) is a finding.

The voronoi and cluster-colors decoders run on ``--device``; the other
seven parse in the host C runtime on either device, apart from D2 under
``--gates``. The last line is ``campaign done: {json}``: each family's
trials, ok and raised outcomes and findings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..codecs import from_spec
from ..ops import hufdec
from . import env_gates, open_device

FAMILIES = ["hufman", "zip(dict)", "zip(back)", "hilbert(rle)",
            "hilbert(rle(2))", "hilbert(zip)", "delta",
            "cluster-colors(4)", "voronoi(4)"]
ALLOWED = (ValueError,)
SHAPES = ((16, 24), (1, 40), (33, 7), (64, 64), (5, 129))
# sources whose Huffman payloads (hufman and delta) exceed D2's chunk
GATED = ("hufman", "delta")
GATE = "CNIIC_DEVICE_HUF_DECODE"
GATED_SHAPES = ((64, 64), (48, 120))
MAX_VALUES = 3 << 27   # the wire layer's plausibility cap, in bytes


class Finding(Exception):
    """A decode that broke the contract without raising."""


def source_images(rng, shapes=SHAPES):
    """Copy of the original's sources: half a flat colour, half noise."""
    for h, w in shapes:
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = rng.integers(0, 256, 3)
        img[h // 2:, :] = rng.integers(0, 256, (h - h // 2, w, 3))
        yield img


def mutate(rng, data: np.ndarray) -> bytes:
    """Copy of the original's mutator: one of six kinds a call."""
    n = data.size
    kind = rng.integers(0, 6)
    if kind == 0 and n:  # truncate
        return bytes(data[: rng.integers(0, n)])
    if kind == 1 and n:  # burst corruption (1-16 bytes)
        m = data.copy()
        pos = int(rng.integers(0, n))
        ln = int(rng.integers(1, 17))
        m[pos : pos + ln] = rng.integers(0, 256, min(ln, n - pos))
        return bytes(m)
    if kind == 2 and n:  # bit flips (1-4)
        m = data.copy()
        for _ in range(int(rng.integers(1, 5))):
            m[rng.integers(0, n)] ^= 1 << int(rng.integers(0, 8))
        return bytes(m)
    if kind == 3 and n > 8:  # splice two halves at a random joint
        a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
        return bytes(np.concatenate([data[:a], data[b:]]))
    if kind == 4:  # random garbage
        return bytes(rng.integers(0, 256, int(rng.integers(0, 600)))
                     .astype(np.uint8))
    m = data.copy()  # header-focused byte smash
    if n:
        m[rng.integers(0, min(n, 32))] = rng.integers(0, 256)
    return bytes(m)


def outcome(codec, blob: bytes):
    """("raised", None) when decode raised the ValueError family, ("ok",
    image) for a plausible image; raises Finding for any other image and
    lets any other exception through."""
    try:
        out = codec.decode(blob)
    except ALLOWED:
        return "raised", None
    if not (isinstance(out, np.ndarray) and out.dtype == np.uint8
            and out.ndim == 3 and out.shape[2] == 3
            and out.size <= MAX_VALUES):
        raise Finding(f"malformed decode output {type(out).__name__} "
                      f"{getattr(out, 'shape', None)}")
    return "ok", out


def encoded_sources(codec, rng, shapes=SHAPES):
    """The encodable sources' streams as uint8 arrays (a k-means floor on
    a tiny image is a legitimate refusal)."""
    streams = []
    for img in source_images(rng, shapes):
        try:
            streams.append(np.frombuffer(codec.encode(img), np.uint8))
        except ValueError:
            pass
    return streams


def mutated_blobs(codec, seed: int, n: int, shapes=SHAPES) -> list:
    """n mutated streams of `codec`'s sources, one generator seeded with
    `seed` drawing the sources and then the mutations, as `run_family`
    draws them."""
    rng = np.random.default_rng(seed)
    streams = encoded_sources(codec, rng, shapes)
    return [mutate(rng, streams[rng.integers(0, len(streams))])
            for _ in range(n)]


def _record(out_dir, label, seed, trial, blob, err) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = label.replace("(", "_").replace(")", "").replace("+", "_")
    path = os.path.join(out_dir, f"fuzz_finding_{tag}_{seed}_{trial}.bin")
    with open(path, "wb") as fh:
        fh.write(blob)
    print(f"FINDING {label}: {err!r} (blob -> {path})", flush=True)


def run_family(label, codec, streams, rng, trials=0, seconds=60.0,
               against=None, out_dir="findings", seed=0) -> dict:
    """Mutate and decode `trials` blobs (or for `seconds`); with `against`
    (a codec on another device) compare each outcome with its own."""
    tally = {"trials": 0, "ok": 0, "raised": 0, "findings": 0,
             "d2_decodes": 0, "d2_declines": 0}
    t0 = time.perf_counter()
    while (tally["trials"] < trials if trials
           else time.perf_counter() - t0 < seconds):
        blob = mutate(rng, streams[rng.integers(0, len(streams))])
        tally["trials"] += 1
        d2 = (hufdec.decodes, hufdec.declines)
        try:
            try:
                got, img = outcome(codec, blob)
            finally:
                tally["d2_decodes"] += hufdec.decodes - d2[0]
                tally["d2_declines"] += hufdec.declines - d2[1]
            if against is not None:
                ref, ref_img = outcome(against, blob)
                if ref != got or (got == "ok"
                                  and not np.array_equal(img, ref_img)):
                    raise Finding(f"{got} on {codec.device}, {ref} on "
                                  f"{against.device}")
        except Exception as e:  # noqa: BLE001 - the finding class
            tally["findings"] += 1
            _record(out_dir, label, seed, tally["trials"], blob, e)
            continue
        tally[got] += 1
    return tally


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seconds", nargs="?", type=float, default=60.0,
                    help="seconds a family without --trials")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--trials", type=int, default=0)
    ap.add_argument("--gates", action="store_true")
    ap.add_argument("--against", choices=["cpu"])
    ap.add_argument("--out", default="findings")
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    if dev is None:
        return 1
    seed = (args.seed if args.seed is not None
            else int(np.random.SeedSequence().entropy % (1 << 63)))
    print(f"seed {seed}", flush=True)
    rng = np.random.default_rng(seed)
    runs = [(spec, None) for spec in FAMILIES]
    if args.gates:
        runs += [(spec, GATE) for spec in GATED]
    summary = {}
    for spec, gate_name in runs:
        label = spec if gate_name is None else f"{spec}+D2"
        codec = from_spec(spec, device=dev)
        against = (from_spec(spec, device=args.against) if args.against
                   else None)
        streams = encoded_sources(
            codec, rng, SHAPES if gate_name is None else GATED_SHAPES)
        if not streams:
            print(f"{label}: no encodable sources, skipping", flush=True)
            continue
        walks = hufdec.walk.launches
        with env_gates([gate_name] if gate_name else []):
            tally = run_family(label, codec, streams, rng, args.trials,
                               args.seconds, against, args.out, seed)
        if gate_name is not None:
            tally["walk_launches"] = hufdec.walk.launches - walks
        summary[label] = tally
        print(f"{label}: {tally['trials']} mutated streams, "
              f"{tally['ok']} decoded, {tally['raised']} raised, "
              + ("CLEAN" if not tally["findings"]
                 else f"{tally['findings']} finding(s)")
              + (f"; D2 decoded {tally['d2_decodes']}, declined "
                 f"{tally['d2_declines']}, walk launches "
                 f"{tally['walk_launches']}" if gate_name else ""),
              flush=True)
    findings = sum(t["findings"] for t in summary.values())
    print("campaign done: " + json.dumps({
        "seed": seed, "device": str(dev), "against": args.against,
        "findings": findings, "families": summary}), flush=True)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

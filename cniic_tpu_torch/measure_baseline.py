"""Measure the single-core host-CPU baseline for the bench line's vs_baseline.

Copy of ``scripts/measure_baseline.py``, unchanged apart from its imports,
``main(argv)``, the one-core setting and the file it writes. The reference
binary cannot be built in-container (no rustc/cargo, zero egress), so the
measured baseline is this package itself **on the host CPU of the card's
machine**, by design not on the card: every codec runs with
``device="cpu"``, pinned to one core (``os.sched_setaffinity``) with one
torch thread (``torch.set_num_threads(1)``), the single-core reference's
class of machine. For the LZ/Huffman/RLE families the hot loops are the
same C the production path uses (the reference's own algorithms), so the
baseline if anything *over*-states the Rust's speed; for the k-means codecs
the denominators are the port's plain CPU versions of K1 and D3 (blocked
int64 torch ops), as the TPU-era file's were XLA on the CPU.
vs_baseline is therefore a reproducible measurement of what the card buys
per codec.

Run ALONE on the machine (concurrent work makes the timings lie):

    python -m cniic_tpu_torch.measure_baseline   # writes BASELINE_HOST_H100.json

``python -m cniic_tpu_torch.bench`` picks the file up. The document names
the host's CPU model and product name, the card beside it (nvidia-smi's
name and power limit, or "none") and the core and thread setting, and each
leg's seconds.
``BASELINE_HOST.json`` is the TPU host's history and is not written.

Matched-content mode: `--images=<glob>` measures the same protocol on a
deterministic linspace sample of a real corpus instead of bench's synthetic
content, so a north-star numerator and its denominator share content
statistics:

    python -m cniic_tpu_torch.measure_baseline --images='data/ns1000/*.png' \\
        --out=BASELINE_HOST_H100_NS.json

--only=<name,...> re-measures just the named legs (codec .name values)
and splices them into the existing --out file, leaving every other
denominator untouched — the baseline-side analog of northstar's
--remeasure, and the way to run the slow k-means legs in calls of their
own.
"""

from __future__ import annotations

import glob as globlib
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from . import bench, image_io
from .codecs import from_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = "BASELINE_HOST_H100.json"
CPUINFO = "/proc/cpuinfo"

# corpus-sample sizes per codec (--images mode): the host k-means legs run
# minutes per megapixel on natural content, so they get smaller (still
# deterministic) samples; everything else gets a corpus-scale chunked
# sample measured with the northstar protocol (below)
_CORPUS_SAMPLE = {"voronoi_128": 2, "cluster-colors_32": 4}
_CORPUS_DEFAULT_N = 128
_CORPUS_CHUNK = 32

NOTES = ("k-means denominators (cluster-colors_32, voronoi_128) are the "
         "port's plain CPU versions of K1 and D3; the other legs run the "
         "host C runtime the card's path runs; encode_s is the timed encode "
         "(median of 3 passes, or 1 pass when the first took 30 s or more), "
         "leg_s the leg's wall time, warmup and decode included")


def _corpus_sample(paths: list[str], n: int) -> list[str]:
    """Deterministic spread over the sorted corpus (captures a mixed-
    statistics corpus' full range instead of one end of it)."""
    idx = np.linspace(0, len(paths) - 1, num=min(n, len(paths))).astype(int)
    return [paths[i] for i in sorted(set(idx.tolist()))]


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names its first processor: the model
    name or, where a virtual machine reports none ("unknown"), the vendor,
    family and model numbers; else what `platform` says."""
    info = {}
    try:
        with open(CPUINFO) as fh:
            for line in fh:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')} (no model name reported)")
    return platform.processor() or platform.machine()


def machine() -> str:
    """The host's product name (DMI), or "unknown"."""
    try:
        with open("/sys/devices/virtual/dmi/id/product_name") as fh:
            return fh.read().strip() or "unknown"
    except OSError:
        return "unknown"


def card_label() -> str:
    """The card beside the host, as nvidia-smi names it with its power
    limit, or "none"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "none"
    return out.strip().splitlines()[0] if out.strip() else "none"


def one_core() -> dict:
    """Pin this process to one CPU of its affinity set and torch to one
    thread; returns the setting for the document."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[0]})
    torch.set_num_threads(1)
    return {"cpu": cpus[0], "of_cpus": len(cpus), "torch_threads": 1}


def _measure_legs(only, corpus_paths, out: dict, sampled: dict) -> None:
    """Time each leg of ``bench.SUITE`` (those in `only`, when given) into
    `out`, the corpus sample of each into `sampled`."""
    rng = np.random.default_rng(2024)
    corpus_cache = {}  # path -> loaded image, shared across fast legs
    for spec, side, n_imgs in bench.SUITE:
        codec = from_spec(spec, device="cpu")
        if corpus_paths is None:
            # drawn before the --only skip, so a spliced leg times the
            # images a whole run (and the bench line) gives it
            imgs = [bench.synth_image(rng, side, side) for _ in range(n_imgs)]
            warm = imgs
        if only is not None and codec.name not in only:
            continue
        t_leg = time.perf_counter()
        if corpus_paths is not None and codec.name not in _CORPUS_SAMPLE:
            # Fast C legs: corpus-scale CHUNKED steady state, the exact
            # northstar protocol (warm on the first 8 real images, then
            # accumulate encode seconds over chunks of 32; rate = total
            # MP / total s): a small repeated sample re-encodes a cache-hot
            # working set and reads faster than the same C at corpus scale.
            sample = _corpus_sample(corpus_paths, _CORPUS_DEFAULT_N)
            # every fast leg uses the same default sample — record it once
            sampled["default"] = [os.path.basename(p) for p in sample]
            for p in sample:
                if p not in corpus_cache:
                    corpus_cache[p] = image_io.load_image(p)
            simgs = [corpus_cache[p] for p in sample]
            codec.encode_batch(simgs[:8])
            mp = enc_s = 0.0
            all_blobs = []
            for ci in range(0, len(simgs), _CORPUS_CHUNK):
                chunk_imgs = simgs[ci:ci + _CORPUS_CHUNK]
                t0 = time.perf_counter()
                blobs = codec.encode_batch(chunk_imgs)
                enc_s += time.perf_counter() - t0
                mp += sum(im.shape[0] * im.shape[1]
                          for im in chunk_imgs) / 1e6
                all_blobs.extend(blobs)
            # decode over the FULL sample
            codec.decode(all_blobs[0])
            t0 = time.perf_counter()
            for b in all_blobs:
                codec.decode(b)
            dec_s = time.perf_counter() - t0
            out[codec.name] = {"encode_mps": round(mp / enc_s, 4),
                               "decode_mps": round(mp / dec_s, 4),
                               "encode_s": round(enc_s, 3), "passes": 1,
                               "leg_s": round(time.perf_counter() - t_leg, 3)}
            print(f"{codec.name}: encode {mp/enc_s:.3f} MP/s, "
                  f"decode {mp/dec_s:.3f} MP/s", file=sys.stderr,
                  flush=True)
            continue
        if corpus_paths is not None:
            take = _CORPUS_SAMPLE[codec.name]
            sample = _corpus_sample(corpus_paths, take)
            sampled[codec.name] = [os.path.basename(p) for p in sample]
            imgs = [image_io.load_image(p) for p in sample]
            # cluster-colors warms on the real sample itself (its cost
            # depends on the unique-colour statistics, which easy synthetic
            # content does not reproduce); the others on easy content at
            # the same image shapes
            if codec.name.startswith("cluster-colors"):
                warm = imgs
            else:
                warm = [bench.synth_image(rng, im.shape[0], im.shape[1])
                        for im in imgs]
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        # warmup at the EXACT batch shape; the fast legs then get
        # median-of-3 timed passes, the k-means legs (minutes per pass)
        # stay single-pass, gated on the first pass' cost so the rule is
        # mechanical, not per-codec
        codec.encode_batch(warm)
        t0 = time.perf_counter()
        blobs = codec.encode_batch(imgs)
        enc_s = time.perf_counter() - t0
        passes = 1
        if enc_s < 30.0:
            times = [enc_s]
            for _ in range(2):
                t0 = time.perf_counter()
                blobs = codec.encode_batch(imgs)
                times.append(time.perf_counter() - t0)
            enc_s = sorted(times)[1]
            passes = 3
        # NOTE: decode here is the per-image decode() loop, not the bench's
        # batched/fused decode path — decode_mps is a host reference point,
        # NOT the denominator of any published speedup (the bench computes
        # vs_baseline from encode only)
        for b in blobs[:1]:
            codec.decode(b)  # decode-side warm (tables, caches)
        t0 = time.perf_counter()
        for b in blobs:
            codec.decode(b)
        dec_s = time.perf_counter() - t0
        out[codec.name] = {"encode_mps": round(mp / enc_s, 4),
                           "decode_mps": round(mp / dec_s, 4),
                           "encode_s": round(enc_s, 3), "passes": passes,
                           "leg_s": round(time.perf_counter() - t_leg, 3)}
        print(f"{codec.name}: encode {mp/enc_s:.3f} MP/s, "
              f"decode {mp/dec_s:.3f} MP/s ({passes} timed pass(es), leg "
              f"{out[codec.name]['leg_s']} s)", file=sys.stderr, flush=True)



def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    corpus_glob, out_name = None, DEFAULT_OUT
    only = None
    for a in argv:
        if a.startswith("--images="):
            corpus_glob = a.split("=", 1)[1]
        elif a.startswith("--out="):
            out_name = a.split("=", 1)[1]
        elif a.startswith("--only="):
            only = {s for s in a.split("=", 1)[1].split(",") if s}
    corpus_paths = None
    if corpus_glob is not None:
        corpus_paths = sorted(globlib.glob(corpus_glob))
        if not corpus_paths:
            print(f"no images match {corpus_glob}", file=sys.stderr)
            return 1

    out = {}
    sampled = {}
    prev = None
    out_path = os.path.join(REPO, out_name)
    if only is not None:
        # splice mode: start from the existing file, re-measure only the
        # named legs (everything else keeps its recorded denominator)
        with open(out_path) as f:
            prev = json.load(f)
        unknown = only - set(prev["per_codec"])
        if unknown:
            print(f"--only: not in {out_name}: {sorted(unknown)}",
                  file=sys.stderr)
            return 1
        out = prev["per_codec"]
        sampled = prev.get("corpus", {}).get("sampled", sampled)
    saved = (os.sched_getaffinity(0), torch.get_num_threads())
    setting = one_core()
    print(f"measuring on the host CPU ({cpu_model()}), one core "
          f"(cpu {setting['cpu']} of {setting['of_cpus']}) and one torch "
          f"thread, beside card {card_label()}; every codec on "
          "device='cpu'", file=sys.stderr, flush=True)
    try:
        _measure_legs(only, corpus_paths, out, sampled)
    finally:  # a caller in the same process gets its cores back
        os.sched_setaffinity(0, saved[0])
        torch.set_num_threads(saved[1])

    if prev is None:
        doc = {"host": (f"{cpu_model()}, the host CPU beside the card, one "
                        "core, one torch thread; every codec on "
                        "device='cpu'"),
               "cpu_model": cpu_model(), "machine": machine(),
               "card": card_label(), "threads": setting,
               "package": "cniic_tpu_torch",
               "notes": NOTES}
    else:  # a splice keeps the file's header and records its own setting
        doc = prev
        doc.setdefault("spliced", []).append(
            {"legs": sorted(only), "cpu_model": cpu_model(),
             "card": card_label(), "threads": setting})
    doc["per_codec"] = out
    if corpus_paths is not None:
        doc["corpus"] = {"glob": corpus_glob, "images": len(corpus_paths),
                         "sampled": sampled}
    elif prev is not None and "corpus" in prev:
        doc["corpus"] = prev["corpus"]
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

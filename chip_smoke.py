#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cniic_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py                  # needs one card; exits 0 on success
    python3 chip_smoke.py --rehearse-cpu   # the same phases, tiny, on the CPU

Phases:

1. the device: its name and power limit, the torch, CUDA, nvcc and cc
   versions;
2. the build, all libraries at once (one compiler process each): K1 and
   D3 (`csrc/kmeans_assign.cu`), K2 and K3 (`csrc/approx_rle.cu`), D1 and
   D2 (`csrc/huffman_dev.cu`), all with nvcc for sm_90a, with the
   registers, shared memory and spills ptxas reports, and the host C
   runtime (`csrc/cniic_native.c`), all from the sources in this checkout;
3. every kernel against its plain PyTorch version at real widths, exact
   equality of every output. K1: (a) voronoi-like, 4 lanes x 1024^2
   points, d = 5, k = 128; (b) cluster-colors-like, 8 lanes of unique
   colours weighted by their counts, d = 3, k = 32; (c) duplicated points
   and centroids; (d) a frozen lane; (e) k = 2048 at 65536 points (the
   large-k statistics branch); (f) the unpacked path at a 3840x2160
   voronoi bound with duplicated points and centroids; (g) the unpacked
   path with global statistics, d = 2 at coordinates up to 16383, k = 4096.
   D3 on (a)'s statistics with emptied clusters (the steal), a frozen lane
   and a plateauing lane, two steps, with max_iters free and binding. The
   whole iteration in one launch (K1 with D3 in each lane's last block)
   against K1's then D3's plain versions, every tensor after every step: at
   (a), at (a) with D3's cases, at (b) over many steps, and on both
   global-statistics branches; then its kernel alone against K1's alone and
   K1 then D3, beside the bound of K1 and D3 together, and what an
   iteration of the loop costs the host and the card with one launch and
   with two. K1's pruned instance (the bound filter in front of its scan,
   the loop's step for voronoi at k >= 512 on the unpacked path): (h) the
   2040x1356 image at k = 2048, one lane, every tensor against K1's then
   D3's plain versions over the loop's first steps with the share of
   points it scanned, then the whole loop as the engine drives it against
   the unpruned kernel (iterations, assignment, centroids equal), each
   kernel's mean time alone over the loop in turns, its launches and the
   points it scanned over the loop. K2 (its chunk schedule and one walker
   a stream, records and flags) on the chunks the chunked route cuts from the Hilbert scans: (a)
   a 1024^2 scan, 1024 chunks, allow 4; (b) the same at allow 16; (c) the
   2040x1356 scan, 1024 chunks of 2702, allow 4; (d) crafted boundary ties
   at allow 2 (flags set); (e) allow 64; (f) 1024 flat streams, whose
   seams never sync; (g) flat streams with +-4 noise; with the repair
   pass's sync share and the settle pass's re-walked positions, both
   schedules in turns at (a), (c) and (f), and the kernels alone by the
   profiler. K3 (its
   chunk schedule and one walker a stream) on 8 streams of 16384 pixels
   opening with crafted boundary runs at allow 4, 16 and 64; then the chunk
   schedule against one walker a stream at full size (the 8 suite scans,
   the 2040x1356 scan, 8 flat images and 8 flat images with +-4 noise),
   with the repair pass's sync share and the settle pass's re-walked
   positions, both schedules in turns and the kernels alone. D1 on the
   8 Hufman id streams of the 1024^2 images in one batched launch, on one
   delta stream through the single route and on a geometric codebook with
   63-bit codes, each with its one-pass schedule and with one thread a
   symbol, both schedules timed in turns and alone, and everything the one
   pass puts on the card by name; D2's two passes at K = 0 and the default K, and its root
   table, on a 1024^2 Hufman payload and a delta payload, and its decline
   on a deep-code stream; D1 and D2 also against the native C packer and
   decoder; D2's passes timed at both K in turns. Then each
   kernel and its plain version timed on the card in turns (plain, kernel,
   kernel, plain), each beside its bound (the larger of its bytes over
   3.35 TB/s and its operations over the card's peak rate for their type)
   and roofline share, and the K2/K3 and D1/D2 routes against the C paths
   (host clock), the K2 route split into its K2 calls, record extraction,
   the stitcher's adoption and its native replays;
4. the main paths through the normal entry points, each with the kernel
   counts set to 0 just before it and read just after: `runner.
   measure_all(from_spec(spec, device="cuda"), paths, batch=8)` over 8
   images of 1024^2 (bench.py's recipe, seed 2024) and one 2040x1356
   image, written as PNGs. (i) cluster-colors(32) and voronoi(128): K1 must
   have launched once an iteration and D3 never alone (the update runs in
   K1's last blocks; launches, iterations and the loops' host checks are
   printed per codec), the fused voronoi decode+MSE must have run, and the
   runner must not have fallen back to per-image decode; cluster-colors'
   colour histograms on the card (one upload and one sort for the 9
   images) must equal `native.hist_rgb` image by image and its streams
   the CPU path's, both histograms timed in turns; then a
   torch.profiler window over one warm `encode_batch` of each (8 images)
   prints the device busy share, K1's share and the kernels an iteration
   (`cniic_tpu_torch.kmeans_profile.encode_window`). (ii) hilbert(rle),
   hilbert(rle(4)) and hilbert(zip) with no gate (the host C runtime), then
   hilbert(rle(4)) under CNIIC_CHUNKED_RLE=1 (K2 must have launched and the
   streams must equal the ungated ones byte for byte) and under
   CNIIC_PALLAS_RLE=1 (K3 must have launched; calls and kernel launches
   of both are printed). (iii) hufman, delta,
   zip(dict) and zip(back) with no gate (the host C runtime), then hufman,
   delta and cluster-colors(32) under CNIIC_DEVICE_BITPACK=1 (D1 must have
   launched, the streams must equal the ungated ones) and under
   CNIIC_DEVICE_HUF_DECODE=1 (D2 and its root table must have launched and
   D2 declined nowhere, the MSEs must equal the ungated ones: 0 for the
   lossless codecs), then the gated routes' encode/decode MP/s beside the
   ungated ones;
5. the card against the CPU: identical streams for two 256^2 crops with the
   k-means codecs, with hilbert(rle(4)) under each of its gates and with
   hufman, delta and cluster-colors(32) under each Huffman gate (identical
   decodes too; the CPU runs the plain versions), the phase-4 voronoi
   streams decoded on the CPU give the MSEs measured on the card, and the
   golden 3840x2160 image (seed 42) encodes with voronoi(128) on the card
   to the stream whose hash the tests pin;
6. the multi-device layer (`cniic_tpu_torch.parallel.mesh`) and `entry`,
   with the kernel counts set to 0 before each part and read after: (a)
   `sharded_kmeans` over the golden 3840x2160 image's 8,294,400 voronoi
   points (d = 5, k = 128) on a world of 1 under NCCL and on a world of 2
   ranks sharing the card under gloo (spawned), each equal to `km.kmeans`
   on the card (centroids, assignment, iterations), with the time an
   iteration beside the single-device loop's (both on the card's clock,
   CUDA events), the all-reduces' share of the loop, and at the world of 1
   the iteration split into K1, D3, the all-reduce, the candidate gather
   and copies, and idle gaps (profiler), beside the host's time to issue
   an iteration; (b) on the same two gloo ranks, voronoi(128) and
   cluster-colors(32) `encode_batch` over phase 4's 8 images of 1024^2,
   lane-sharded: streams and fused MSEs equal phase 4's; (c) `entry()`'s
   fn on the card equal to its CPU run; (d) `dryrun_multichip(1)` on the
   NCCL group. K1 and D3 must have launched on both sharded worlds;
7. the experiment layer: (a) `synth_corpus` makes the 12 --midtex images
   of 2040x1356 (the images `output_midtex`'s CSVs were computed from:
   image i only comes from generating 0..i in order); (b) `sweep.main`
   runs the 22-config matrix over them, overlapped, `--device=cuda
   --batch=8`, the kernel counts set to 0 just before and read just after;
   (c) columns 2-4 of every row of the 22 CSVs (264) must equal
   `output_midtex/<name>.csv`'s, matched by image basename, and each
   difference is printed; (d) K1 must have launched in every k-means
   config of the device queue, its pruned instance in the sweep, and D3
   never alone: each config's iterations, K1 launches (of them pruned), K1
   branch (packed or unpacked; shared-memory or global statistics) and
   seconds are printed; (e) the two queues'
   wall times, the total and the configs' serial sum; (f) `northstar.main`
   over 16 --ns images of 1024^2 at --chunk=8 must verify every round trip,
   and prints each codec's encode and decode MP/s. In a rehearsal: 2 plain
   images of 256^2, 4 configs, no reference comparison.
8. campaigns and profiles (`cniic_tpu_torch.experiments`), every kernel
   count set to 0 before and read after: (a) `fuzz_campaign.main` with a
   fixed seed and 30 mutated streams a family over the nine families, then
   hufman and delta under CNIIC_DEVICE_HUF_DECODE=1 (`--gates`), every
   blob also decoded on the CPU (`--against=cpu`): no finding, every
   outcome equal to the CPU's (raised, or equal pixels), D2 decoded
   mutated payloads and `walk_kernel` launched; (b)
   `roundtrip_campaign.main` over seeds 1..10 on the card with no gate and
   with `--gates=k2,k3,d1,d2`, and on the CPU: no finding, K1 launched in
   the first and K1, K2, K3, D1 and D2 in the gated run, and each spec's
   stream hashes equal the CPU run's (under k3 hilbert(rle(3))'s batch
   lanes are held against K3's plain route inside the run); (c)
   `profile_clusterc.main` (hist / kmeans / parts / huf) and
   `kmeans_phase_probe.main` (prep / upload / loop windows / fetch of
   cluster-colors(32) and voronoi(128)) over phase 4's 9 images, each
   line beside the card's name and power limit. In a rehearsal: 8 streams
   a family, one round-trip seed.

It ends with a line holding the card's name and power limit, a JSON line
describing each kernel of the paths (K1's pruned instance a row of its own,
its launches phase 7's, its times (h)'s; K1's and D3's with their launches on
phase 6's sharded paths, `launches_sharded`, in each of its runs,
`launches_phase_6`, and over phase 7's sweep, `launches_phase_7`; every
kernel's launches over phase 8, `launches_phase_8`, and K1's row the
phase-8 profiles), and the JSON result line. Any failure
raises (non-zero exit, no result line). Without a card it fails unless
--rehearse-cpu is given, and then its last line says "platform": "cpu".
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from cniic_tpu_torch import (_build, hilbert, huffman, kmeans_profile, native,
                             northstar, runner, sweep, synth_corpus)
from cniic_tpu_torch.codecs import ClusterColors, VoronoiCluster, from_spec
from cniic_tpu_torch.codecs import delta as delta_codec
from cniic_tpu_torch.codecs.base import pixels_row_major
from cniic_tpu_torch.experiments import (fuzz_campaign, kmeans_phase_probe,
                                         profile_clusterc, roundtrip_campaign)
from cniic_tpu_torch.image_io import load_image, save_png
from cniic_tpu_torch.ops import (approx_rle, bitpack, color_hist, histogram,
                                 hufdec, kmeans_kernel)
from cniic_tpu_torch.ops import kmeans as km

K1_SOURCE = "cniic_tpu_torch/csrc/kmeans_assign.cu"
K1_REPLACES = "cniic_tpu/ops/kmeans_pallas.py:52"
D3_REPLACES = "cniic_tpu/ops/kmeans.py:245"
RLE_SOURCE = "cniic_tpu_torch/csrc/approx_rle.cu"
K2_REPLACES = "cniic_tpu/ops/approx_rle.py:246"
K3_REPLACES = "cniic_tpu/ops/approx_rle.py:54"
SPECS = ("cluster-colors(32)", "voronoi(128)")
HILBERT_SPECS = ("hilbert(rle)", "hilbert(rle(4))", "hilbert(zip)")
GATED = "hilbert(rle(4))"
GATES = ("CNIIC_CHUNKED_RLE", "CNIIC_PALLAS_RLE")
HUF_SOURCE = "cniic_tpu_torch/csrc/huffman_dev.cu"
D1_REPLACES = "cniic_tpu/ops/bitpack.py:43"
D2_REPLACES = "cniic_tpu/ops/hufdec.py:82"
HOST_SPECS = ("hufman", "delta", "zip(dict)", "zip(back)")
HUF_SPECS = ("hufman", "delta", "cluster-colors(32)")
HUF_GATES = ("CNIIC_DEVICE_BITPACK", "CNIIC_DEVICE_HUF_DECODE")
# sha256 of the voronoi(128) stream of synth_natural(seed 42, 2160 x
# 3840), the stream committed as tests/fixtures/voronoi128_synth4k.bin
VORONOI_4K_SHA = ("df51eee5af16fd1a47af40fea1e8cc1112aacf3d8f8d6fe48a6dfa69911b"
                  "a857")

# the H100 SXM's published peak rates, for the bounds
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 1979e12   # int8 tensor cores: the card's fastest integer rate
F32_OPS_PER_S = 67e12     # float32 outside the tensor cores

# (real, rehearsal) sizes
SIZES = {
    False: dict(side=1024, div2k=(1356, 2040), crop=256, tie_n=70000,
                frozen_n=200000, bigk_side=256, iters=20, k3_len=16384,
                pruned_steps=30),
    True: dict(side=64, div2k=(68, 102), crop=32, tie_n=3000,
               frozen_n=2000, bigk_side=64, iters=2, k3_len=1024,
               pruned_steps=2),
}
# phase 6: the image whose voronoi points the point-sharded k-means takes
# (the golden 4K image), and its k
SIZES[False].update(mesh_img=(2160, 3840), mesh_k=128)
SIZES[True].update(mesh_img=(54, 96), mesh_k=16)
# phase 7: the sweep's corpus (12 --midtex images of 2040x1356, the
# images of output_midtex's rows; in a rehearsal 2 plain images of 256^2),
# its configs (None: the 22 of the matrix) and the north-star corpus
SIZES[False].update(exp_n=12, exp_configs=None, ns_n=16, ns_side=1024)
SIZES[True].update(exp_n=2, exp_side=256,
                   exp_configs=("hufman", "hilbert(rle(4))",
                                "cluster-colors(16)", "voronoi(64)"),
                   ns_n=16, ns_side=64)
# phase 8: the fuzz campaign's seed and trials a family, the round-trip
# campaign's seed0 and trials (seeds seed0+1..seed0+trials; the rehearsal's
# seed 19 has small images, since the gated plain versions are slow)
SIZES[False].update(fuzz_seed=2024, fuzz_trials=30, rt_seed0=0, rt_trials=10)
SIZES[True].update(fuzz_seed=2024, fuzz_trials=8, rt_seed0=18, rt_trials=1)
# the committed matrix the sweep's rows are held against
MIDTEX_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "output_midtex")

# (allow, count c, t0, t1, t2): a run of c pixels then a pixel x with
# t = S - c*x, where the f32 distance sum fma(t2, t2, fma(t0, t0, t1*t1))
# rejects x and the unfused sum would accept it
K3_FMA_CASES = [(64, 98, -2577, -763, 5667), (64, 246, -6038, -13622, 5085),
                (64, 86, 4459, 131, 3224)]
# the boundary tie K2 must flag at allow 2 (tests/torch_rle_cases.py)
TIE = np.array([[3, 3, 3], [3, 3, 2], [4, 4, 3], [2, 2, 2]], np.uint8)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def run(argv) -> str:
    return subprocess.run(argv, capture_output=True, text=True,
                          check=True).stdout


def synth_image(rng, h: int, w: int) -> np.ndarray:
    """bench.py's recipe: low-frequency fields, flat patches, mild noise."""
    yy = np.linspace(0, 4 * np.pi, h)[:, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :]
    base = (110 + 70 * np.sin(xx * 0.7 + 1.3) * np.cos(yy * 0.5)
            + 45 * np.sin(0.23 * (xx * 3 + yy * 2)))
    img = np.stack([base, base * 0.8 + 30, 255 - base * 0.6], axis=-1)
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        hh, ww = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
        img[y0:y0 + hh, x0:x0 + ww] = rng.integers(0, 256, 3)
    img = img + rng.normal(0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def synth_natural(rng, h: int, w: int) -> np.ndarray:
    """Natural-statistics field: 1/f^1.8 spectrum, correlated channels,
    flat patches, mild noise (the recipe of
    scripts/make_synth_corpus.py::synth_natural; seed 42 at 2160 x 3840 is
    the image of the golden 4K pins)."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = f[0, 1]
    spec = 1.0 / f ** 1.8

    def field():
        ph = rng.normal(size=(h, w // 2 + 1)) + 1j * rng.normal(size=(h, w // 2 + 1))
        x = np.fft.irfft2(ph * spec, s=(h, w))
        lo, hi = np.percentile(x, [1, 99])
        return np.clip((x - lo) / (hi - lo + 1e-9), 0, 1)

    lum = field()
    c1, c2 = field(), field()
    r = np.clip(lum * 0.75 + c1 * 0.35 - 0.05, 0, 1)
    g = np.clip(lum * 0.85 + c2 * 0.20 - 0.02, 0, 1)
    b = np.clip(lum * 0.65 + (1 - c1) * 0.30, 0, 1)
    img = np.stack([r, g, b], axis=-1) * 255.0
    for _ in range(int(rng.integers(4, 9))):
        y0, x0 = rng.integers(0, h * 3 // 4), rng.integers(0, w * 3 // 4)
        hh, ww = rng.integers(h // 12, h // 4), rng.integers(w // 12, w // 4)
        patch = img[y0:y0 + hh, x0:x0 + ww]
        img[y0:y0 + hh, x0:x0 + ww] = patch.mean(axis=(0, 1))
    img = img + rng.normal(0, 1.4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# phase 1 and 2
# ---------------------------------------------------------------------------

def phase_device(rehearse: bool):
    if rehearse:
        print("phase 1: rehearsal on the CPU (plain versions, tiny sizes)")
        return torch.device("cpu"), "cpu (rehearsal)"
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card (--rehearse-cpu rehearses "
                           "it on the CPU)")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip().splitlines()[0]
    print(f"phase 1: device {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"  nvcc: {run([_build.nvcc(), '--version']).strip().splitlines()[-1]}")
    cc = os.environ.get("CC", "cc")
    print(f"  cc: {run([cc, '--version']).splitlines()[0]}")
    return torch.device("cuda"), card


def _ptxas_entries(log: str) -> dict:
    """kernel entry name -> (registers, spill store B, spill load B, smem B)
    from an `nvcc -Xptxas -v` log."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        check(regs is not None and spills is not None,
              f"ptxas reported no registers or spills for {name}")
        out[name] = (int(regs.group(1)), int(spills.group(1)),
                     int(spills.group(2)), int(smem.group(1)) if smem else 0)
    return out


def phase_build(rehearse: bool) -> None:
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from sources
    jobs = {"C runtime": native._load}
    if not rehearse:
        jobs["K1"] = kmeans_kernel.load_library
        jobs["K2+K3"] = approx_rle.load_library
        jobs["D1+D2"] = bitpack.load_library
    seconds, errors = {}, {}

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors[name] = e
        seconds[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=build, args=item)
               for item in jobs.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for name, e in errors.items():
        raise SmokeFailure(f"building {name} failed") from e
    print(f"phase 2: built {', '.join(jobs)} in parallel in {wall:.2f} s ("
          + ", ".join(f"{n} {t:.2f} s" for n, t in seconds.items()) + ")")
    if rehearse:
        print("  K1, D3, K2, K3, D1 and D2 not built (no nvcc in a rehearsal)")
        return
    with open(_build.log_path(kmeans_kernel.NAME)) as fh:
        k1 = _ptxas_entries(fh.read())
    steps = [v for name, v in k1.items() if "step_update_kernel" in name]
    k1 = {name: v for name, v in k1.items() if "assign_stats_kernel" in name}
    # 8 dimensions x statistics branch x packed x with or without the
    # update, and the pruned instance (d = 5, unpacked, with the update) on
    # both statistics branches
    check(len(k1) == 66, f"ptxas reported {len(k1)} of 66 K1 kernels")
    # D3 alone gathering the steal's points, and given them
    check(len(steps) == 2, f"ptxas reported {len(steps)} D3 kernels")
    for name, (regs, st, ld, smem) in sorted(k1.items()):
        m = re.search(r"ILi(\d)ELb([01])ELb([01])ELb([01])ELb([01])E", name)
        check(m is not None, f"unexpected K1 instance {name}")
        if m.group(5) == "1":
            print(f"  ptxas K1 pruned, d={m.group(1)}, "
                  f"{'shared-memory' if m.group(2) == '1' else 'global'} "
                  f"stats: {regs} registers, {smem} B static smem, {st} B "
                  "spills")
        # the main path's: shared-memory statistics, packed, d of the codecs
        elif m.group(1) in ("3", "5") and m.group(2) == m.group(3) == "1":
            print(f"  ptxas K1 d={m.group(1)} shared-memory stats, packed, "
                  f"{'with' if m.group(4) == '1' else 'without'} the update: "
                  f"{regs} registers, {smem} B static smem, {st} B spills")
    print(f"  K1, all 66 instances: max {max(v[0] for v in k1.values())} "
          f"registers, max {max(v[1] for v in k1.values())} B spills; D3 "
          f"alone (both modes) {max(v[0] for v in steps)} registers, "
          f"{max(v[1] for v in steps)} B spills")
    check(bitpack.load_library().huf_pack_tile() == bitpack.TILE,
          "bitpack.TILE is not the tile huffman_dev.cu was built with")
    with open(_build.log_path(approx_rle.NAME)) as fh:
        rle = _ptxas_entries(fh.read())
    with open(_build.log_path(bitpack.NAME)) as fh:
        rle.update(_ptxas_entries(fh.read()))
    # the chunk passes are one template each for K2 (WideState) and K3
    # (BatchState)
    for label, key, count in (
            ("K2", "wide_kernel", 1), ("K3", "batch_kernel", 1),
            ("K2 and K3", "speculate_kernel", 2),
            ("K2 and K3", "repair_kernel", 2),
            ("K2 and K3", "settle_kernel", 2), ("K2", "wide_flags_kernel", 1),
            ("D1", "pack_tiles_kernel", 2), ("D1", "book_kernel", 1),
            ("D1", "pack_kernel", 1), ("D2", "walk_kernel", 2),
            ("D2", "table_kernel", 1)):
        found = sorted((n, v) for n, v in rle.items() if key in n)
        check(len(found) == count, f"ptxas reported {len(found)} {key} "
              f"entries, not {count}")
        for name, (regs, st, ld, smem) in found:
            if "WideState" in name or "BatchState" in name:
                inst = "<K2>" if "WideState" in name else "<K3>"
            else:
                inst = re.search(r"ILb([01])E", name)
                inst = (f"<{'true' if inst.group(1) == '1' else 'false'}>"
                        if inst else "")
            print(f"  ptxas {label} ({key}{inst}): {regs} registers, {smem} B "
                  f"static smem, {st} B spill stores, {ld} B spill loads")


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------

def _synthetic_step(seed, B, d, n, k, maxv, dev, ties=False, frozen=False):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, maxv, (B, d, n)).astype(np.int32)
    cents = rng.integers(0, maxv, (B, k, d)).astype(np.int32)
    if ties:
        pts[:, :, n // 2:] = pts[:, :, : n - n // 2]
        cents[:, k // 2:] = cents[:, : k - k // 2]
    ns = np.array([n - 7 * b for b in range(B)], np.int32)
    w = rng.integers(1, 200, (B, n)).astype(np.int32)
    cur = rng.integers(0, k, (B, n)).astype(np.int32)
    for b in range(B):
        w[b, ns[b]:] = 0
        cur[b, ns[b]:] = 0
    act = np.ones(B, np.int32)
    if frozen:
        act[-1] = 0
    ops = [torch.from_numpy(a).to(dev) for a in (pts, w, cur, cents, ns, act)]
    return ops, [maxv - 1] * d


def _time_ms(fn, iters: int, dev, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _unpacked_step(seed, pmax, B, n, k, dev):
    """Points and centroids spread over [0, pmax] (past the packed bound),
    half the points and centroids duplicated, points on every centroid."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.integers(0, m + 1, (B, n)) for m in pmax],
                   axis=1).astype(np.int32)
    pts[:, :, n // 2:] = pts[:, :, : n - n // 2]
    cents = np.ascontiguousarray(
        pts[:, :, rng.integers(0, n, k)].transpose(0, 2, 1))
    cents[:, k // 2:] = cents[:, : k - k // 2]
    m = min(n, k)
    pts[:, :, :m] = cents[:, :m].transpose(0, 2, 1)
    ops = [pts, rng.integers(1, 9, (B, n)).astype(np.int32),
           rng.integers(0, k, (B, n)).astype(np.int32), cents,
           np.full(B, n, np.int32), np.ones(B, np.int32)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in ops], list(pmax)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def bound(nbytes: int, ops: float = 0.0, peak: float = INT_OPS_PER_S):
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(ops, with_update: bool = False):
    """K1 on these operands: each valid point of an active lane read once
    (d coordinates, w, cur) and its new id written once, the centroids read
    and the statistics written once; d multiply-adds per (point, centroid)
    pair (2 operations each), counted at the card's fastest integer rate.
    with_update: the whole iteration, K1's bytes and D3's (`d3_bound`)."""
    ptsT, _, _, cents, n, act = ops
    _, d, _ = ptsT.shape
    k = cents.shape[1]
    points = int(torch.where(act != 0, n, 0).sum())
    lanes = int((act != 0).sum())
    nbytes = (points * (d + 3) * 4 + lanes * k * (d * 4 + (d + 1) * 8))
    if with_update:
        nbytes += lanes * k * (2 * (d + 1) * 8 + d * 4)
    return bound(nbytes, 2.0 * points * k * d)


def d3_bound(ops):
    """D3: the statistics read and zeroed, the centroids written (the lane
    scalars are noise)."""
    sums, cents = ops[0], ops[4]
    return bound(2 * _nbytes(sums) + _nbytes(cents))


def _d3_state(k1_ops, k1_out, max_iters: int):
    """D3's operands from a K1 step: its statistics with every fifth cluster
    of lane 0 emptied (the steal), lane 1 frozen and lane 2 one stall short
    of the plateau limit, at a large iteration."""
    ptsT, _, _, cents, n, act = k1_ops
    B = ptsT.shape[0]
    dev = ptsT.device
    sums = k1_out[1].clone()
    sums[0, ::5] = 0
    act = act.clone()
    act[1] = 0
    i64 = dict(dtype=torch.int64, device=dev)
    moved = torch.full((B,), 10**6, **i64)
    moved[1] = 0  # frozen: no move left above the threshold
    best = torch.full((B,), 10**6, **i64)
    stall = torch.zeros(B, **i64)
    stall[2] = 63
    best[2] = 0  # no 2% improvement on 0 moves: lane 2 plateaus
    return [sums, k1_out[2].clone(), ptsT, n, cents.clone(), moved, best,
            stall, act, torch.full((B,), 2**31 + 5, **i64),
            torch.zeros(B, **i64), 64, max_iters]


def _fused_case(name, k1_ops, pmax, steps, dev, d3_cases=False,
                pruned=False):
    """`steps` whole iterations (K1 with D3 in each lane's last block, one
    launch) against K1's then D3's plain versions on the same device, every
    tensor compared after every step. d3_cases: clusters of lane 0 that no
    point can reach (the steal, at a large iteration), lane 1 frozen, lane 2
    one stall short of the plateau limit, and max_iters binding at the
    second step. pruned: K1's pruned instance, with the bound filter's
    state for the loop (on the card; the plain versions in a rehearsal).
    Returns the max |err| (and, pruned, the plain versions' ms a step and
    the share of points scanned in each step)."""
    ptsT, w, cur, cents, n, act = [t.clone() for t in k1_ops]
    B, d, _ = ptsT.shape
    k = cents.shape[1]
    i64 = dict(dtype=torch.int64, device=dev)
    n64 = n.to(torch.int64)
    moved, best = n64 + 1, n64 + 1
    stall, it = torch.zeros(B, **i64), torch.zeros(B, **i64)
    thresh = torch.zeros(B, **i64)
    stall_lim, max_iters = 64, 1 << 40
    if d3_cases:
        # a centroid equal to the one before it loses every tie to it
        cents[0, 1::5] = cents[0, 0:-1:5][: cents[0, 1::5].shape[0]]
        cur[0] = torch.where(cur[0] % 5 == 1, cur[0] - 1, cur[0])
        act[1] = 0
        moved[1] = 0
        stall[2] = 63
        best[2] = 0
        it += 2**31 + 5
        max_iters = 2**31 + 7
    state = [torch.zeros((B, k, d + 1), **i64),
             torch.zeros(B, dtype=torch.int32, device=dev), moved, best, stall,
             it, thresh]
    want = [t.clone() for t in (cur, cents, act, *state)]
    bounds = (kmeans_kernel.prune_state(cents, ptsT.shape[2])
              if pruned and dev.type == "cuda" else None)
    step = kmeans_kernel.prepare_step(ptsT, w, cur, cents, n, act, pmax,
                                      *state, stall_lim, max_iters,
                                      bounds=bounds)
    check(step.pruned == (bounds is not None), f"{name}: the wrong instance")
    err = 0
    stolen = 0
    shares, plain_s = [], 0.0
    for _ in range(steps):
        if bounds is None:
            step()
        else:
            live = int(torch.where(act != 0, n, 0).sum())
            scanned = kmeans_kernel.scanned_points()
            step()
            shares.append((kmeans_kernel.scanned_points() - scanned)
                          / max(live, 1))
        w_cur, w_cents, w_act, w_sums, w_mk, *w_rest = want
        _sync(dev)
        t0 = time.perf_counter()
        new, sums, mk = kmeans_kernel.assign_stats_ref(ptsT, w, w_cur, w_cents,
                                                       n, w_act)
        keep = (w_act != 0)[:, None] & (torch.arange(
            ptsT.shape[2], device=dev)[None, :] < n[:, None])
        w_cur.copy_(torch.where(keep, new, w_cur))
        stolen += int(((sums[:, :, d] == 0) & (w_act != 0)[:, None]).sum())
        kmeans_kernel.step_update_ref(sums, mk, ptsT, n, w_cents, *w_rest[:3],
                                      w_act, *w_rest[3:], stall_lim, max_iters)
        _sync(dev)
        plain_s += time.perf_counter() - t0
        err = max(err, _max_err([cur, cents, act, *state[2:6]],
                                [w_cur, w_cents, w_act, *w_rest[:4]]),
                  int(state[0].abs().max()), int(state[1].abs().max()))
    print(f"  K1 + D3 in one launch ({name}) B={B} d={d} k={k}, {steps} "
          f"steps: max |err| of cur, cents, act, moved, best, stall, it "
          f"(statistics left zero) = {err}; it {it.tolist()}, act "
          f"{act.tolist()}, {stolen} steals")
    if bounds is not None:
        print(f"    pruned instance: points scanned a step over the active "
              f"lanes' points, steps 1-5 "
              f"{', '.join(f'{x:.4f}' for x in shares[:5])}, the last five "
              f"{', '.join(f'{x:.4f}' for x in shares[-5:])}")
    check(err == 0, f"the fused step differs from K1's and D3's plain "
          f"versions in {name}")
    if d3_cases:
        check(stolen > 0, "the crafted centroids emptied no cluster")
        check(it.tolist() == [2**31 + 7, 2**31 + 5, 2**31 + 6, 2**31 + 7]
              and not bool(act.any()),
              "the fused step did not stop at a binding max_iters")
    if pruned:
        return err, plain_s * 1e3 / steps, shares
    return err


def _loop_cost(step, iters: int, dev):
    """(host us, wall us) an iteration of `iters` enqueued back to back: the
    host's time to enqueue them, and the time until the card has run them."""
    step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    t1 = time.perf_counter()
    _sync(dev)
    t2 = time.perf_counter()
    return (t1 - t0) * 1e6 / iters, (t2 - t0) * 1e6 / iters


def _step_timings(key, k1_ops, pmax, k1_alone_ms, dev, card, sz):
    """The whole iteration at a main-path shape, every lane kept active and
    the state set back before each call: one launch (K1 with D3 in its last
    blocks, the kernel the main path runs) against two (K1, then D3 alone),
    the kernels alone by the profiler, the one launch and the two plain
    versions by events in turns, its bound and roofline share, and what an
    iteration of the loop costs the host and the card."""
    ptsT, w, cur0, cents0, n, act = k1_ops
    B, d, _ = ptsT.shape
    k = cents0.shape[1]
    i64 = dict(dtype=torch.int64, device=dev)
    out = {}
    for fused in (True, False):
        cur, cents = cur0.clone(), cents0.clone()
        n64 = n.to(torch.int64)
        state = [torch.zeros((B, k, d + 1), **i64),
                 torch.zeros(B, dtype=torch.int32, device=dev), n64 + 1,
                 n64 + 1, torch.zeros(B, **i64), torch.zeros(B, **i64),
                 torch.full((B,), -1, **i64)]   # thresh -1: no lane freezes
        step = kmeans_kernel.prepare_step(
            ptsT, w, cur, cents, n, act.clone(), pmax, *state, 1 << 40,
            1 << 40, fused=fused)

        def from_init(step=step, cur=cur, cents=cents):
            cur.copy_(cur0)
            cents.copy_(cents0)
            step()

        out[fused] = (step, from_init)
    keys = {True: ("assign_stats_kernel",),
            False: ("assign_stats_kernel", "step_update_kernel")}
    alone = {f: _kernels_ms(out[f][1], keys[f], dev) for f in (True, False)}
    p_state = [t.clone() for t in (cents0, act, *state[2:])]

    def plain():
        new, sums, mk = kmeans_kernel.assign_stats_ref(ptsT, w, cur0, cents0,
                                                       n, act)
        p_state[0].copy_(cents0)
        kmeans_kernel.step_update_ref(sums, mk, ptsT, n, p_state[0],
                                      *p_state[2:5], p_state[1],
                                      *p_state[5:], 1 << 40, 1 << 40)

    few = max(2, sz["iters"] // 4)
    p1 = _time_ms(plain, few, dev, warmup=1)
    c1 = _time_ms(out[True][1], sz["iters"], dev)
    c2 = _time_ms(out[True][1], sz["iters"], dev)
    p2 = _time_ms(plain, few, dev, warmup=1)
    b_ms, b_by = k1_bound(k1_ops, with_update=True)
    # the loop as `_drive` runs it: the state moves on from call to call
    cost = {}
    for f in (False, True, True, False):
        cost.setdefault(f, []).append(_loop_cost(out[f][0], 5 * sz["iters"],
                                                 dev))
    one, two = cost[True], cost[False]
    print(f"  time the iteration ({key}) on {card}: kernels alone (profiler, "
          f"from the init state) one launch {alone[True] * 1e3:.2f} us, K1 "
          f"then D3 {alone[False] * 1e3:.2f} us, K1 without the update "
          f"{k1_alone_ms * 1e3:.2f} us: the update in K1's last blocks adds "
          f"{(alone[True] - k1_alone_ms) * 1e3:.2f} us; a copy of cur and "
          f"cents then the one launch {c1 * 1e3:.1f} / {c2 * 1e3:.1f} us by "
          f"events, K1's then D3's plain versions {p1 * 1e3:.1f} / "
          f"{p2 * 1e3:.1f} us (plain, kernel, kernel, plain); bound of K1 "
          f"and D3 {b_ms * 1e3:.2f} us ({b_by}), roofline share of the one "
          f"launch alone {b_ms / alone[True]:.4f}; the loop, host / "
          f"wall us an iteration (two, one, one, two launches): "
          f"{two[0][0]:.1f} / {two[0][1]:.1f}, {one[0][0]:.1f} / "
          f"{one[0][1]:.1f}, {one[1][0]:.1f} / {one[1][1]:.1f}, "
          f"{two[1][0]:.1f} / {two[1][1]:.1f}")
    return {"fused_alone_ms": alone[True], "split_alone_ms": alone[False],
            "fused_tail_ms": alone[True] - k1_alone_ms,
            "fused_call_ms": (c1 + c2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": b_ms, "bound_by": b_by,
            "loop_host_us": sum(c[0] for c in one) / 2,
            "loop_wall_us": sum(c[1] for c in one) / 2,
            "loop_host_us_two_launches": sum(c[0] for c in two) / 2,
            "loop_wall_us_two_launches": sum(c[1] for c in two) / 2}


@contextlib.contextmanager
def _unpruned():
    """While entered, the engine's loops take the unpruned kernel."""
    real = km.pruned_path
    km.pruned_path = lambda *args: False
    try:
        yield
    finally:
        km.pruned_path = real


def _pruned_loop(ops, pmax, dev, card):
    """K1's pruned instance over a whole voronoi(2048) loop as the engine
    drives it (`_drive`, to its end), against the unpruned kernel over the
    same loop: equal (iters, cur, cents); the kernel's mean time alone over
    the loop's launches by the profiler, in turns (pruned, unpruned,
    unpruned, pruned), its launches and the points it scanned."""
    ptsT, w, cur0, cents0, n, _ = ops
    k = cents0.shape[1]

    def drive():
        return km._drive(ptsT, w, cur0.clone(), cents0.clone(), n.tolist(),
                         k, pmax, 10_000)

    before = (kmeans_kernel.assign_stats.pruned_launches,
              kmeans_kernel.scanned_points())
    got = drive()
    launches = kmeans_kernel.assign_stats.pruned_launches - before[0]
    scanned = kmeans_kernel.scanned_points() - before[1]
    with _unpruned():
        want = drive()
    err = max(abs(got[0] - want[0]), _max_err(got[1:], want[1:]))
    ms = {}
    for pruned in (True, False, False, True):
        with contextlib.nullcontext() if pruned else _unpruned():
            ms.setdefault(pruned, []).append(_kernels_split(
                drive, ("assign_stats_kernel",), dev, calls=1)
                ["assign_stats_kernel"])
    share = scanned / max(1, got[0] * int(n.sum()))
    print(f"  (h) the loop to its end on {card}: {got[0]} iterations, "
          f"{launches} pruned launches; max |err| of iters, cur, cents "
          f"against the unpruned kernel = {err}; points scanned over the "
          f"loop's points {share:.4f}; kernel alone, mean over the loop's "
          f"launches: pruned {ms[True][0]:.4f} / {ms[True][1]:.4f} ms, "
          f"unpruned {ms[False][0]:.4f} / {ms[False][1]:.4f} ms (pruned, "
          f"unpruned, unpruned, pruned)")
    check(err == 0, "the pruned loop differs from the unpruned kernel's")
    check(dev.type != "cuda" or launches == got[0] + (-got[0]) % 8,
          f"the pruned loop made {launches} pruned launches for {got[0]} "
          "iterations")
    return {"iterations": got[0], "launches": launches, "err": err,
            "scanned_share": share, "ms": sum(ms[True]) / 2,
            "unpruned_ms": sum(ms[False]) / 2}


def phase_kernel(imgs, dev, card, sz):
    cases = {
        "a voronoi": kmeans_profile.voronoi_operands(imgs[:4], 128, dev),
        "b cluster-colors": kmeans_profile.colour_operands(imgs[:8], 32,
                                                          dev),
        "c ties": _synthetic_step(1, 2, 5, sz["tie_n"], 128, 1024,
                                          dev, ties=True),
        "d frozen lane": _synthetic_step(2, 3, 5, sz["frozen_n"], 64,
                                                2048, dev, frozen=True),
        "e large k": kmeans_profile.voronoi_operands(
            [imgs[0][:sz["bigk_side"], :sz["bigk_side"]]], 2048, dev),
        "f unpacked, 3840x2160 bound": _unpacked_step(
            3, [3839, 2159, 255, 255, 255], 2, sz["tie_n"], 128, dev),
        "g unpacked, d=2 at 16383": _unpacked_step(
            4, [16383, 16383], 2, sz["frozen_n"] // 10, 4096, dev),
    }
    print("phase 3: K1 against its plain version (exact equality)")
    max_err = 0
    outs = {}
    for name, (ops, pmax) in cases.items():
        t0 = time.perf_counter()
        want = kmeans_kernel.assign_stats_ref(*[t.cpu() for t in ops])
        t_ref = time.perf_counter() - t0
        got = kmeans_kernel.assign_stats(*ops, pmax=pmax)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        outs[name] = got
        errs = [int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(got, want)]
        max_err = max(max_err, *errs)
        B, d, n = ops[0].shape
        k = ops[3].shape[1]
        path = "packed" if kmeans_kernel.packed_path(pmax, k) else "unpacked"
        branch = ("" if dev.type != "cuda" else
                  ", shared-memory stats" if kmeans_kernel.stats_in_smem(d, k)
                  else ", global-memory stats")
        print(f"  ({name}) B={B} d={d} n={n} k={k}, {path}{branch}: max "
              f"|err| of new, sums, moved = {errs}; moved "
              f"{got[2].tolist()} (CPU plain version {t_ref:.1f} s)")
        check(errs == [0, 0, 0], f"K1 differs from its plain version in {name}")
    paths = {kmeans_kernel.packed_path(pmax, ops[3].shape[1])
             for ops, pmax in cases.values()}
    check(paths == {True, False}, "the cases do not cover both K1 paths")

    print("phase 3 (cont.): D3 against its plain version (exact equality)")
    a_ops = cases["a voronoi"][0]
    d3_err = 0
    for max_iters in (2**40, 2**31 + 6):
        got = _d3_state(a_ops, outs["a voronoi"], max_iters)
        want = [t.cpu().clone() if torch.is_tensor(t) else t for t in got]
        for step in range(2):
            kmeans_kernel.step_update_ref(*want)
            kmeans_kernel.step_update(*got)
            err = _max_err(got[:11], want[:11])
            d3_err = max(d3_err, err)
            print(f"  D3 (a) max_iters {max_iters}, step {step + 1}: max "
                  f"|err| of sums, moved_k, cents, moved, best, stall, act, "
                  f"it = {err}; it {got[9].tolist()}, act "
                  f"{got[8].tolist()}, stall {got[7].tolist()}")
            check(err == 0, f"D3 differs from its plain version (max_iters "
                  f"{max_iters}, step {step + 1})")
    check(int(got[9].max()) == 2**31 + 6 and not bool(got[8].any()),
          "D3 did not stop at a binding max_iters")
    # the mode the point-sharded k-means runs: the empty clusters take the
    # candidates given (here unrelated to ptsT) instead of a gather
    got = _d3_state(a_ops, outs["a voronoi"], 2**40)
    B, k, d = got[4].shape
    stolen = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1024, (B, k, d)).astype(np.int32)).to(dev)
    want = [t.cpu().clone() if torch.is_tensor(t) else t for t in got]
    empty = (want[0][:, :, d] == 0) & (want[8] != 0)[:, None]
    for step in range(2):
        kmeans_kernel.step_update_ref(*want, stolen=stolen.cpu())
        kmeans_kernel.step_update(*got, stolen=stolen)
        err = _max_err(got[:11], want[:11])
        d3_err = max(d3_err, err)
        print(f"  D3 (a) given the steal's candidates, step {step + 1}: max "
              f"|err| of sums, moved_k, cents, moved, best, stall, act, it "
              f"= {err}; {int(empty.sum())} empty clusters at step 1")
        check(err == 0, f"D3 given the candidates differs from its plain "
              f"version (step {step + 1})")
    check(bool(empty.any()) and torch.equal(
        want[4][empty], stolen.cpu()[empty]),
        "the empty clusters did not take the candidates given")

    print("phase 3 (cont.): the whole iteration in one launch against K1's "
          "then D3's plain versions (exact equality)")
    b_ops, b_pmax = cases["b cluster-colors"]
    e_ops, e_pmax = cases["e large k"]
    g_ops, g_pmax = cases["g unpacked, d=2 at 16383"]
    many = 10 * sz["iters"]
    fused_err = max(
        _fused_case("a voronoi", a_ops, cases["a voronoi"][1], sz["iters"],
                    dev),
        _fused_case("a voronoi, D3's cases", a_ops, cases["a voronoi"][1], 3,
                    dev, d3_cases=True),
        _fused_case("b cluster-colors", b_ops, b_pmax, many, dev),
        _fused_case("e large k, global statistics", e_ops, e_pmax,
                    sz["iters"], dev),
        _fused_case("g unpacked, global statistics", g_ops, g_pmax, many,
                    dev))
    d3_err = max(d3_err, fused_err)

    print("phase 3 (cont.): K1's pruned instance (the bound filter in front "
          "of its scan, with D3 and the snapshots in each lane's last block) "
          "against K1's then D3's plain versions (exact equality)")
    h_ops, h_pmax = kmeans_profile.voronoi_operands([imgs[8]], 2048, dev)
    check(dev.type != "cuda" or kmeans_kernel.pruned_path(5, 2048, h_pmax),
          "the 2040x1356 image at k = 2048 is not on the pruned path")
    h_err, h_plain_ms, h_shares = _fused_case(
        "h pruned, 2040x1356 at k = 2048", h_ops, h_pmax, sz["pruned_steps"],
        dev, pruned=True)
    h_loop = _pruned_loop(h_ops, h_pmax, dev, card)
    h_bound = k1_bound(h_ops, with_update=True)
    print(f"  time the pruned instance (h) on {card}: {h_loop['ms']:.4f} ms "
          f"a launch over the loop alone, K1's then D3's plain versions "
          f"{h_plain_ms:.1f} ms a step; bound of K1 and D3 "
          f"{h_bound[0] * 1e3:.2f} us ({h_bound[1]}), roofline share "
          f"{h_bound[0] / h_loop['ms']:.4f} (unpruned "
          f"{h_bound[0] / h_loop['unpruned_ms']:.4f})")
    timings = {"pruned": {**h_loop, "err": max(h_err, h_loop["err"]),
                          "plain_ms": h_plain_ms, "bound_ms": h_bound[0],
                          "bound_by": h_bound[1],
                          "first_step_shares": h_shares[:5]}}
    for key, name in (("a", "a voronoi"), ("b", "b cluster-colors")):
        ops, pmax = cases[name]
        B, d, n_max = ops[0].shape
        k = ops[3].shape[1]
        bufs = (torch.zeros((B, n_max), dtype=torch.int32, device=dev),
                torch.zeros((B, k, d + 1), dtype=torch.int64, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
        kernel = lambda: kmeans_kernel.assign_stats(  # noqa: E731
            *ops, pmax=pmax, out=bufs)
        plain = lambda: kmeans_kernel.assign_stats_ref(*ops)  # noqa: E731
        p1 = _time_ms(plain, sz["iters"], dev)
        k1 = _time_ms(kernel, sz["iters"], dev)
        k2 = _time_ms(kernel, sz["iters"], dev)
        p2 = _time_ms(plain, sz["iters"], dev)
        b_ms, b_by = k1_bound(ops)
        dev_ms = _kernels_ms(kernel, ("assign_stats_kernel",), dev)
        timings[key] = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, b_by, dev_ms)
        print(f"  time K1 without the update ({key}) on {card}: kernel "
              f"{k1 * 1e3:.1f} / "
              f"{k2 * 1e3:.1f} us per launch, plain version {p1 * 1e3:.1f} / "
              f"{p2 * 1e3:.1f} us (plain, kernel, kernel, plain; "
              f"{sz['iters']} launches each); kernel alone (profiler) "
              f"{dev_ms * 1e3:.1f} us; bound {b_ms * 1e3:.2f} us ({b_by}), "
              f"roofline share {b_ms / ((k1 + k2) / 2):.4f} "
              f"({b_ms / dev_ms:.4f} of the kernel alone)")
    ops = _d3_state(a_ops, outs["a voronoi"], 2**40)
    ops[10] = ops[10] - 1          # thresh -1 and no plateau limit keep
    ops[11] = 1 << 40              # every lane active from call to call
    ops[8] = torch.ones_like(ops[8])
    sums0 = ops[0].clone()
    # each call after a fresh copy of the statistics (D3 zeroes them)
    kernel = lambda: (ops[0].copy_(sums0),  # noqa: E731
                      kmeans_kernel.step_update(*ops))
    plain = lambda: (ops[0].copy_(sums0),  # noqa: E731
                     kmeans_kernel.step_update_ref(*ops))
    p1 = _time_ms(plain, sz["iters"], dev)
    k1 = _time_ms(kernel, sz["iters"], dev)
    k2 = _time_ms(kernel, sz["iters"], dev)
    p2 = _time_ms(plain, sz["iters"], dev)
    b_ms, b_by = d3_bound(ops)
    dev_ms = _kernels_ms(kernel, ("step_update_kernel",), dev)
    # the events see the host's enqueue rate (the wrapper's checks take
    # longer than the kernel), so D3's time is the kernel's own
    timings["D3"] = (dev_ms, (p1 + p2) / 2, b_ms, b_by, (k1 + k2) / 2)
    for key, name in (("a", "a voronoi"), ("b", "b cluster-colors")):
        timings[f"step {key}"] = _step_timings(
            key, *cases[name], timings[key][4], dev, card, sz)
    print(f"  time D3 (a) on {card}: kernel alone (profiler) "
          f"{dev_ms * 1e3:.2f} us; a copy of the statistics then a call: "
          f"kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us, plain version "
          f"{p1 * 1e3:.1f} / {p2 * 1e3:.1f} us (plain, kernel, kernel, "
          f"plain); bound {b_ms * 1e3:.3f} us ({b_by}), roofline share "
          f"{b_ms / dev_ms:.4f}")
    return max_err, d3_err, timings


# ---------------------------------------------------------------------------
# phase 3: K2 and K3 against their plain versions
# ---------------------------------------------------------------------------

def _chunks(scan):
    """The chunks approx_rle_chunked gives K2 for one scan: at most 1024
    chunks of 1024 pixels or more; (scans [S, chunk, 3], lens [S])."""
    return approx_rle._wide_chunks(scan)[:2]


def _run_then_pixel(c, t):
    """A run of c pixels whose sums S give t = S - c*x against the pixel x
    that follows it (tests/torch_rle_cases.py)."""
    t = np.asarray(t)
    q = np.floor_divide(t, c)
    u = 128 + (q + 1) // 2
    x = u - q
    run = np.tile(u, (c, 1))
    for ch in range(3):
        run[: t[ch] - c * q[ch], ch] += 1
    check((run.sum(0) - c * x == t).all(), "crafted run")
    return np.concatenate([run, x[None]]).astype(np.uint8)


def _boundary_runs(allow, rng, n):
    """n crafted runs whose next pixel sits exactly on K3's threshold
    (sum t^2 == (allow*c)^2), or within one unit of it, plus the f32
    rounding cases at allow 64."""
    out = [_run_then_pixel(c, t) for a, c, *t in K3_FMA_CASES if a == allow]
    while len(out) < n:
        c = int(rng.integers(3, 250))
        lim = min(allow * c, 100 * c)
        t01 = rng.integers(-lim, lim + 1, (4096, 2))
        rem = (allow * c) ** 2 - (t01.astype(np.int64) ** 2).sum(1)
        root = np.sqrt(np.maximum(rem, 0)).round().astype(np.int64)
        hit = np.flatnonzero((rem >= 0) & (root * root == rem)
                             & (root <= 100 * c))
        if hit.size:
            i = hit[0]
            off = len(out) % 3 - 1  # on, above and below the threshold
            out.append(_run_then_pixel(c, [t01[i, 0], t01[i, 1],
                                           root[i] + off]))
    return out


def _rle_err(got, want) -> int:
    return max(int((g.cpu().to(torch.int64) - w.cpu().to(torch.int64))
                   .abs().max()) for g, w in zip(got, want))


def _time_turns(kernel, plain, iters, dev):
    """(kernel ms, plain ms): plain, kernel, kernel, plain, one warm plain
    run each and `iters` kernel launches each."""
    p1 = _time_ms(plain, 1, dev, warmup=0)
    k1 = _time_ms(kernel, iters, dev)
    k2 = _time_ms(kernel, iters, dev)
    p2 = _time_ms(plain, 1, dev, warmup=0)
    return (k1, k2), (p1, p2)


def _k2_cases(scans):
    """K2's phase-3 cases: (name, (chunks, lens), allow) on the chunks the
    route cuts from the scans, plus flat and flat-plus-noise streams of the
    1024^2 scan's shape."""
    full, div2k = _chunks(scans[0]), _chunks(scans[-1])
    tie = (full[0].copy(), full[1])
    tied = sorted({1, len(tie[1]) // 2, len(tie[1]) - 2})
    for j in tied:
        tie[0][j, :4] = TIE
    rng = np.random.default_rng(13)
    colours = rng.integers(0, 256, (full[0].shape[0], 1, 3))
    flat = np.broadcast_to(colours, full[0].shape).astype(np.uint8)
    noisy = np.clip(colours + rng.integers(-4, 5, full[0].shape), 0,
                    255).astype(np.uint8)
    return tied, {"a 1024^2, allow 4": (full, 4),
                  "b 1024^2, allow 16": (full, 16),
                  "c 2040x1356, allow 4": (div2k, 4),
                  "d ties, allow 2": (tie, 2),
                  "e 1024^2, allow 64": (full, 64),
                  "f flat, allow 4": ((flat, full[1]), 4),
                  "g flat + noise (+-4), allow 4": ((noisy, full[1]), 4)}


def _k2_phase(scans, dev, card, sz):
    """K2's chunk schedule and one walker against the plain version in every
    case (rows and flags), the schedule's statistics, both schedules in
    turns and the kernels alone."""
    tied, cases = _k2_cases(scans)
    chunk = approx_rle.WIDE_CHUNK
    err_all, ops = 0, {}
    for name, ((chunks, lens), allow) in cases.items():
        rgb, ln = approx_rle._position_major(chunks, lens, dev)
        t0 = time.perf_counter()
        want = approx_rle.approx_rle_wide_ref(rgb, ln, allow)
        t_ref = time.perf_counter() - t0
        got, flags, seams, unsynced, walked = approx_rle.wide_records_stats(
            rgb, ln, allow)
        one = approx_rle.wide_records(rgb, ln, allow, chunk=rgb.shape[0])
        _sync(dev)
        err = _rle_err([got, flags, *one], [*want, *want])
        err_all = max(err_all, err)
        flags = flags.cpu()
        forced = int(((got.cpu() >> 25) & 1).sum())
        share = 1 - unsynced / seams if seams else 1.0
        print(f"  K2 ({name}) {chunks.shape[0]} streams x {chunks.shape[1]}, "
              f"chunks of {chunk} and one walker: max |err| {err}, "
              f"{int(flags.sum())} flagged, {forced} stream-end closes; repair "
              f"synced {seams - unsynced} of {seams} seams ({share:.4f}), "
              f"settle re-walked {walked} positions "
              f"({walked / rgb.numel():.4f} of them) (plain version "
              f"{t_ref:.2f} s)")
        check(err == 0, f"K2 differs from its plain version in {name}")
        if name.startswith("d"):
            check(all(int(flags[j]) == 1 for j in tied),
                  "a crafted tie was not flagged")
        ops[name[0]] = dict(rgb=rgb, ln=ln, allow=allow, seams=seams,
                            unsynced=unsynced, walked=walked,
                            # about 40 integer operations a (stream,
                            # position) step
                            bound=bound(_nbytes(rgb, ln, got, flags),
                                        40.0 * rgb.numel()))
    a = ops["a"]

    def chunks_of(o):
        return lambda: approx_rle.wide_records(o["rgb"], o["ln"], o["allow"])

    def one_of(o):
        return lambda: approx_rle.wide_records(o["rgb"], o["ln"], o["allow"],
                                               chunk=o["rgb"].shape[0])

    (k1, k2), (p1, p2) = _time_turns(
        chunks_of(a), lambda: approx_rle.approx_rle_wide_ref(
            a["rgb"], a["ln"], a["allow"]), sz["iters"], dev)
    out = {"err": err_all, "plain_ms": (p1 + p2) / 2, "chunk": chunk,
           "seams": a["seams"], "unsynced": a["unsynced"],
           "rewalked": a["walked"], "bound": a["bound"]}
    for key, label in (("a", "1024^2, allow 4"), ("c", "2040x1356, allow 4"),
                       ("f", "flat, allow 4")):
        o = ops[key]
        (o1, o2), (c1, c2) = _pair_turns(one_of(o), chunks_of(o), sz["iters"],
                                         dev)
        print(f"  time K2 ({label}, {o['rgb'].shape[1]} x "
              f"{o['rgb'].shape[0]}) on {card}: one walker {o1:.4f} / "
              f"{o2:.4f} ms, chunks of {chunk} {c1:.4f} / {c2:.4f} ms a call "
              f"(one, chunks, chunks, one), {(o1 + o2) / (c1 + c2):.2f}x")
        if key == "a":
            out["one_walker_ms"] = (o1 + o2) / 2
    keys = ("speculate_kernel", "repair_kernel", "settle_kernel",
            "wide_flags_kernel")
    split = {k.split("_")[0] if k != keys[-1] else "flags": v for k, v in
             _kernels_split(chunks_of(a), keys, dev).items()}
    alone = sum(split.values())
    one_alone = _kernels_ms(one_of(a), ("wide_kernel",), dev)
    b_ms, b_by = a["bound"]
    out["alone_ms"] = alone
    print(f"  time K2 (1024^2, allow 4) on {card}: chunks {k1:.4f} / "
          f"{k2:.4f} ms a call, plain version {p1:.1f} / {p2:.1f} ms (plain, "
          f"kernel, kernel, plain); kernels alone (profiler) {alone:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"), one walker alone {one_alone:.4f} ms; bound "
          f"{b_ms * 1e3:.3f} us ({b_by}), roofline share {b_ms / alone:.5f} "
          f"(one walker {b_ms / one_alone:.5f})")
    print(f"  K2 kernels alone (profiler) on {card}: 2040x1356 "
          f"{_kernels_ms(chunks_of(ops['c']), keys, dev):.4f} ms, flat "
          f"{_kernels_ms(chunks_of(ops['f']), keys, dev):.4f} ms")
    return out


def _route_split(scans, dev):
    """approx_rle_chunked over the scans at allow 4 on the host clock, split
    into the approx_rle_wide calls (upload, K2, download), `_runs` over the
    chunks' columns, the stitcher's native replays and the rest (the chunk
    packing and the stitcher's adoption). Times in ms."""
    spent = {"wide": 0.0, "runs": 0.0, "native": 0.0}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    saved = (approx_rle.approx_rle_wide, approx_rle._runs,
             native.approx_rle_encode)
    approx_rle.approx_rle_wide = timed("wide", saved[0])
    approx_rle._runs = timed("runs", saved[1])
    native.approx_rle_encode = timed("native", saved[2])
    try:
        t0 = time.perf_counter()
        for sc in scans:
            approx_rle.approx_rle_chunked(sc, 4, device=dev)
        total = time.perf_counter() - t0
    finally:
        (approx_rle.approx_rle_wide, approx_rle._runs,
         native.approx_rle_encode) = saved
    ms = {k: v * 1e3 for k, v in spent.items()}
    return {"total": total * 1e3, "wide call": ms["wide"] - ms["runs"],
            "runs": ms["runs"], "adoption": (total * 1e3 - ms["wide"]
                                             - ms["native"]),
            "native replays": ms["native"]}


def phase_rle_kernels(imgs, dev, card, sz):
    print("phase 3 (cont.): K2 and K3 against their plain versions (exact "
          "equality)")
    scans = [hilbert.linearize(im) for im in imgs]
    k2 = _k2_phase(scans, dev, card, sz)

    L = sz["k3_len"]
    rng = np.random.default_rng(7)
    k3_err = 0
    for allow in (4, 16, 64):
        batch = np.zeros((8, L, 3), np.uint8)
        for j, run in enumerate(_boundary_runs(allow, rng, 8)):
            batch[j, : len(run)] = run
            batch[j, len(run):] = scans[j][: L - len(run)]
        lens = np.full(8, L)
        lens[-1] = L - 5
        rgb, ln = approx_rle._position_major(batch, lens, dev)
        t0 = time.perf_counter()
        want = approx_rle.approx_rle_batch_ref(rgb, ln, float(allow))
        t_ref = time.perf_counter() - t0
        got = approx_rle.batch_records(rgb, ln, float(allow))
        one = approx_rle.batch_records(rgb, ln, float(allow), chunk=L)
        _sync(dev)
        err = _rle_err([got, one], [want, want])
        k3_err = max(k3_err, err)
        print(f"  K3 allow {allow}: 8 streams x {L} opening with crafted "
              f"boundary runs, chunks of {approx_rle.CHUNK} and one walker a "
              f"stream: max |err| {err} (plain version {t_ref:.2f} s)")
        check(err == 0, f"K3 differs from its plain version at allow {allow}")
        if allow == 4:
            k3_timed = (rgb, ln)
            # about 30 float32 operations a pixel step
            k3_bound = bound(_nbytes(rgb, ln, got), 30.0 * rgb.numel(),
                             F32_OPS_PER_S)

    rgb3, ln3 = k3_timed
    (t1, t2), (p1, p2) = _time_turns(
        lambda: approx_rle.batch_records(rgb3, ln3, 4.0),
        lambda: approx_rle.approx_rle_batch_ref(rgb3, ln3, 4.0),
        sz["iters"], dev)
    b_ms, b_by = k3_bound
    k3_timing = ((t1, t2), (p1, p2), b_ms, b_by)
    print(f"  time K3 (8 x {L}) on {card}: kernel {t1:.4f} / {t2:.4f} ms per "
          f"launch, plain version {p1:.1f} / {p2:.1f} ms (plain, kernel, "
          f"kernel, plain); bound {b_ms * 1e3:.3f} us ({b_by}), roofline "
          f"share {2 * b_ms / (t1 + t2):.5f}")
    one_16k = _pair_turns(
        lambda: approx_rle.batch_records(rgb3, ln3, 4.0, chunk=L),
        lambda: approx_rle.batch_records(rgb3, ln3, 4.0), sz["iters"], dev)
    print(f"  time K3 (8 x {L}) on {card}: one walker a stream "
          f"{one_16k[0][0]:.4f} / {one_16k[0][1]:.4f} ms, chunks of "
          f"{approx_rle.CHUNK} {one_16k[1][0]:.4f} / {one_16k[1][1]:.4f} ms "
          "(one, chunks, chunks, one)")
    big, k3_full = _k3_full_size(scans, imgs, dev, card, sz)
    k3_err = max(k3_err, k3_full["err"])
    # where a gated encode's time goes: the whole host-side route against the
    # exact-f64 host engine on the same scans (host clock)
    t0 = time.perf_counter()
    for sc in scans[:8]:
        native.approx_rle_encode(sc, 4.0)
    t_native = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    approx_rle.approx_rle_batch(big, [big.shape[1]] * 8, 4.0, device=dev)
    t_batch = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rgb8, ln8 = approx_rle._position_major(big, [big.shape[1]] * 8, dev)
    recs8 = approx_rle.batch_records(rgb8, ln8, 4.0)
    _sync(dev)
    t_kernel = (time.perf_counter() - t0) * 1e3
    host = approx_rle._stream_major(recs8)
    t_down = (time.perf_counter() - t0) * 1e3 - t_kernel
    t0 = time.perf_counter()
    for j in range(8):
        approx_rle._runs(host[j])
    t_runs = (time.perf_counter() - t0) * 1e3
    route = _route_split(scans[:8], dev)
    print(f"  8 scans of {big.shape[1]} px at allow 4: native engine "
          f"{t_native:.1f} ms, approx_rle_batch (K3 route) {t_batch:.1f} ms "
          f"(upload + K3 {t_kernel:.1f}, stream-major download "
          f"{t_down:.1f}, record extraction {t_runs:.1f}), "
          f"approx_rle_chunked (K2 route) {route['total']:.1f} ms")
    print(f"  K2 route split (host clock, ms over the 8 scans): "
          f"approx_rle_wide call (upload, K2, download) "
          f"{route['wide call']:.1f}, _runs over the chunks' columns "
          f"{route['runs']:.1f}, the stitcher's adoption (and chunk packing) "
          f"{route['adoption']:.1f}, the stitcher's native replays "
          f"{route['native replays']:.1f}")
    return {"K2": k2, "K3": (k3_err, k3_timing),
            "K3 one-walker 8x16384 ms": sum(one_16k[0]) / 2,
            "K3 full": k3_full}


def _pair_turns(a, b, iters, dev, warmup=1):
    """((a ms, a ms), (b ms, b ms)) timed a, b, b, a."""
    a1 = _time_ms(a, iters, dev, warmup=warmup)
    b1 = _time_ms(b, iters, dev, warmup=warmup)
    b2 = _time_ms(b, iters, dev, warmup=warmup)
    a2 = _time_ms(a, iters, dev, warmup=warmup)
    return (a1, a2), (b1, b2)


def _k3_full_size(scans, imgs, dev, card, sz):
    """K3's chunk schedule against the one-walker schedule (chunk >= L) at
    full size: the 8 suite scans (the gated batch of phase 4), the
    2040x1356 scan, 8 flat images and 8 flat images with +-4 noise, all at
    allow 4. Exact equality, the schedule's statistics, both schedules
    timed in turns."""
    big = np.stack(scans[:8])
    n = big.shape[1]
    rng = np.random.default_rng(12)
    colours = rng.integers(0, 256, (8, 1, 3))
    flat = np.broadcast_to(colours, big.shape).astype(np.uint8)
    noisy = np.clip(colours + rng.integers(-4, 5, big.shape), 0,
                    255).astype(np.uint8)
    cases = {"8 x 1024^2 suite scans": big, "2040x1356 scan": scans[-1][None],
             "8 flat images": flat, "8 flat images + noise (+-4)": noisy}
    rehearse = dev.type != "cuda"
    print(f"  K3 at full size, chunks of {approx_rle.CHUNK} against one "
          "walker a stream (exact equality), allow 4:")
    out = {"err": 0}
    for name, batch in cases.items():
        rgb, ln = approx_rle._position_major(batch, [batch.shape[1]]
                                             * batch.shape[0], dev)
        one = lambda: approx_rle.batch_records(  # noqa: E731
            rgb, ln, 4.0, chunk=rgb.shape[0])
        new = lambda: approx_rle.batch_records(rgb, ln, 4.0)  # noqa: E731
        want = one()
        got, seams, unsynced, walked = approx_rle.batch_records_stats(
            rgb, ln, 4.0)
        _sync(dev)
        err = _rle_err([got], [want])
        out["err"] = max(out["err"], err)
        check(err == 0, f"K3's chunk schedule differs from one walker a "
              f"stream on {name}")
        share = 1 - unsynced / seams if seams else 1.0
        line = (f"    {name} ({rgb.shape[1]} x {rgb.shape[0]}): max |err| "
                f"{err}; repair pass synced {seams - unsynced} of {seams} "
                f"seams ({share:.4f}), settle pass re-walked {walked} "
                f"positions ({walked / rgb.numel():.4f} of them)")
        if not rehearse or name.startswith("8 x"):
            (o1, o2), (c1, c2) = _pair_turns(one, new, 1 if rehearse else 2,
                                             dev, warmup=0 if rehearse else 1)
            line += (f"; one walker {o1:.3f} / {o2:.3f} ms, chunks "
                     f"{c1:.4f} / {c2:.4f} ms (one, chunks, chunks, one), "
                     f"{(o1 + o2) / (c1 + c2):.1f}x")
            out[name] = {"ms": (c1 + c2) / 2, "one_walker_ms": (o1 + o2) / 2,
                         "seams": seams, "unsynced": unsynced,
                         "walked": walked}
        print(line)
        if name.startswith("8 x"):
            b_ms, b_by = bound(_nbytes(rgb, ln, got), 30.0 * rgb.numel(),
                               F32_OPS_PER_S)
            out["bound"] = (b_ms, b_by)
            suite = (rgb, ln)
    ms = out["8 x 1024^2 suite scans"]["ms"]
    b_ms, b_by = out["bound"]
    print(f"  K3 bound at 8 x {n}: {b_ms * 1e3:.3f} us ({b_by}); roofline "
          f"share of the chunk schedule {b_ms / ms:.5f} on {card}")
    if not rehearse:
        rgb, ln = suite
        keys = ("speculate_kernel", "repair_kernel", "settle_kernel")
        split = {key.split("_")[0]: _kernels_ms(
            lambda: approx_rle.batch_records(rgb, ln, 4.0), (key,), dev)
            for key in keys}
        alone = sum(split.values())
        out["device_ms"] = alone
        print(f"  K3 at 8 x {n}, chunks of {approx_rle.CHUNK}, kernels alone "
              f"(profiler) on {card}: {alone:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"), roofline share {b_ms / alone:.5f}")
    return big, out


# ---------------------------------------------------------------------------
# phase 3: D1 and D2 against their plain versions
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _max_err(got, want) -> int:
    return max(int((g.cpu().to(torch.int64) - w.cpu().to(torch.int64))
                   .abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _d1_case(name, ids_list, freqs_list, dev):
    """D1 against its plain version on the card and the packed bytes against
    the native C packer; returns (max |err|, operands, n_words)."""
    books = [huffman.build_codebook(f) for f in freqs_list]
    ids, codes, lens, _ = huffman.batch_arrays(ids_list, freqs_list, books)
    # payload bits of the ids as drawn (the geometric case's ids do not
    # follow its frequencies)
    totals = [int(b.lens[sym].astype(np.int64).sum())
              for sym, b in zip(ids_list, books)]
    ops = bitpack.operands(ids, codes, lens, dev)
    n_words = max([(t + 31) // 32 for t in totals] + [1])
    t0 = time.perf_counter()
    want = bitpack.pack_words_ref(*ops, n_words)
    _sync(dev)
    t_ref = time.perf_counter() - t0
    got = bitpack.pack_words(*ops, n_words)
    old = bitpack.pack_words(*ops, n_words, one_pass=False)
    _sync(dev)
    err = _max_err([got, old], [want, want])
    words = got.cpu().numpy()
    for i, (sym, book) in enumerate(zip(ids_list, books)):
        check(bitpack._words_to_bytes(words[i].view(np.uint32), totals[i])
              == native.pack_bits(book.codes, book.lens, sym),
              f"D1 ({name}) stream {i}: bytes differ from the C packer")
    print(f"  D1 ({name}) {ids.shape[0]} x {ids.shape[1]} ids, alphabets "
          f"up to {codes.shape[1] - 1}, codes up to {int(lens.max())} bits, "
          f"{sum(totals)} payload bits, one pass and one thread a symbol: "
          f"max |err| {err}, bytes equal the C packer's (plain version "
          f"{t_ref:.3f} s)")
    check(err == 0, f"D1 differs from its plain version in {name}")
    # about 20 integer operations a symbol
    return err, ops, n_words, bound(_nbytes(*ops, got), 20.0 * ops[0].numel())


def _tree_stream(ids, freqs):
    """(payload, left, right, symbol) of one id stream, packed in C."""
    book = huffman.build_codebook(freqs)
    tree = huffman.serialize_tree(book, np.zeros((freqs.size, 1), np.uint8))
    left, right, symbol, _, _ = huffman.parse_tree(
        np.frombuffer(tree, np.uint8), 1)
    return native.pack_bits(book.codes, book.lens, ids), left, right, symbol


def _d2_case(name, stream, n, dev):
    """Both passes of D2 at K = 0 and the default K, and its root table,
    against the plain versions on the card, and the device decode against
    the native decoder (or both routes declining); returns (max |err|,
    declined, pass-1 operands, pass-1 bound, pass-2 operands and bound or
    None)."""
    payload, left, right, symbol = stream
    pay, lr2, s1, e1, chunk, chunk_ends, total = hufdec.lanes(
        np.frombuffer(payload, np.uint8), left, right, symbol, dev)
    ks = (0, hufdec.TABLE_BITS)
    err = _max_err([hufdec.root_table(lr2, ks[1])],
                   [hufdec.root_table_ref(lr2.cpu(), ks[1])])
    t0 = time.perf_counter()
    want = hufdec.walk_ref(pay, lr2, s1, e1, total)
    _sync(dev)
    t_ref = time.perf_counter() - t0
    for K in ks:
        got = hufdec.walk(pay, lr2, s1, e1, total, K=K)
        err = max(err, _max_err(got[:2], want[:2]))
        check(got[2] == want[2], f"D2 ({name}, K {K}): pass 1 frozen flags "
              "differ")
    composed = hufdec.compose(got[0], got[1], n) if got[2] else None
    pass2 = None
    if composed is not None:
        offs, out_start = (torch.from_numpy(a).to(dev) for a in composed)
        args = (pay, lr2, chunk + offs, chunk_ends, total)
        want2 = hufdec.walk_ref(*args, out_start=out_start, n_symbols=n)
        for K in ks:
            got2 = hufdec.walk(*args, out_start=out_start, n_symbols=n, K=K)
            err = max(err, _max_err([got2[0], got2[1], got2[3]],
                                    [want2[0], want2[1], want2[3]]))
            check(got2[2] == want2[2], f"D2 ({name}, K {K}): pass 2 frozen "
                  "flags differ")
        walked2 = int((got2[0].to(torch.int64) + chunk_ends - args[2]).sum())
        pass2 = ((args, out_start, n), bound(
            _nbytes(pay, lr2, args[2], chunk_ends, out_start, *got2[:2],
                    got2[3]), 8.0 * walked2))
    dec = hufdec.decode_payload_device(payload, left, right, symbol, n,
                                       device=dev)
    declined = composed is None
    check((dec is None) == declined, f"D2 ({name}): the route and the passes "
          "disagree on declining")
    if dec is not None:
        check(np.array_equal(dec, native.huf_decode(payload, left, right,
                                                    symbol, 0, n)),
              f"D2 ({name}): ids differ from the native decoder's")
    print(f"  D2 ({name}) {len(payload)} B payload, {s1.numel()} pass-1 "
          f"lanes, {chunk.numel()} pass-2 lanes, K = {ks[0]} and {ks[1]}, "
          f"the root table: max |err| {err}, "
          + ("declined" if declined else "ids equal the native decoder's")
          + f" (plain pass 1 {t_ref:.2f} s)")
    check(err == 0, f"D2 differs from its plain version in {name}")
    # about 8 integer operations a bit walked (exit - end + end - start bits
    # a lane)
    walked = int((got[0].to(torch.int64) + e1 - s1).sum())
    return err, declined, (pay, lr2, s1, e1, total), bound(
        _nbytes(pay, lr2, s1, e1, got[0], got[1]), 8.0 * walked), pass2


def _kernels_split(fn, keys, dev, calls: int = 10, tries: int = 3) -> dict:
    """{key: device ms a call} of the kernels named by `keys` (one launch of
    each a call), from a torch.profiler window: the mean span of the kernels
    whose names hold the key. The window holds 20 ms of idle host time on
    each side of the calls; one whose trace lacks a key is taken again, up
    to `tries` windows, and the run fails if every window lacks it. In a
    rehearsal (no card) nothing is measured: every key maps to NaN."""
    if dev.type != "cuda":
        fn()
        return {key: math.nan for key in keys}
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        events = kmeans_profile._device_intervals(prof)
        spans = {key: [e - s for s, e, name in events if key in name]
                 for key in keys}
        missing = [key for key, v in spans.items() if not v]
        if not missing:
            return {key: sum(v) / len(v) / 1e3 for key, v in spans.items()}
        print(f"  (profiler window {attempt} of {tries} holds no kernel "
              f"named *{', '.join(missing)}*)")
    raise SmokeFailure(f"the profiler saw no kernel named "
                       f"*{', '.join(missing)}* in {tries} windows")


def _kernels_ms(fn, keys, dev, calls: int = 10) -> float:
    """Device ms a call of the kernels named by `keys`, summed
    (`_kernels_split`); the host time of a call in a rehearsal."""
    if dev.type != "cuda":
        return _time_ms(fn, 1, dev, warmup=0)
    return sum(_kernels_split(fn, keys, dev, calls).values())


def _device_split(fn, dev, calls: int = 10) -> dict:
    """Device ms a call of everything `fn` puts on the card (kernels,
    memsets, copies), by name, from torch.profiler; {} in a rehearsal."""
    if dev.type != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for start, end, name in kmeans_profile._device_intervals(prof):
        name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::",
                                                  ""))
        name = re.split(r"[<(]", name)[0].split("::")[-1]
        out[name] = out.get(name, 0.0) + (end - start) / 1e3 / calls
    return out


def phase_huffman_kernels(imgs, dev, card, sz):
    print("phase 3 (cont.): D1 and D2 against their plain versions (exact "
          "equality)")
    stats = [histogram.color_histogram(pixels_row_major(im)) for im in imgs[:8]]
    d1_err, d1_ops, n_words, d1_bound = _d1_case(
        "a Hufman, 8 images", [s[2] for s in stats], [s[1] for s in stats],
        dev)
    _, dcounts, dinv = delta_codec._scan_stats(imgs[0])
    err, _, _, _ = _d1_case("b delta, 1 image", [dinv], [dcounts], dev)
    d1_err = max(d1_err, err)
    rng = np.random.default_rng(11)
    geo = 2 ** np.arange(64, dtype=np.uint64)
    err, _, _, _ = _d1_case("c geometric codebook",
                         [rng.integers(0, 64, imgs[0].shape[0] ** 2)
                          .astype(np.int32)], [geo], dev)
    d1_err = max(d1_err, err)

    huf = _tree_stream(stats[0][2], stats[0][1])
    d2_err, declined, d2_ops, d2_bound, d2_pass2 = _d2_case(
        "a Hufman", huf, stats[0][2].size, dev)
    check(not declined, "D2 declined the Hufman payload")
    err, declined, _, _, _ = _d2_case("b delta", _tree_stream(dinv, dcounts),
                                      dinv.size, dev)
    check(not declined, "D2 declined the delta payload")
    d2_err = max(d2_err, err)
    deep_ids = rng.integers(0, 40, 30_000).astype(np.int32)
    deep = _tree_stream(deep_ids, 2 ** np.arange(40, dtype=np.uint64))
    err, declined, _, _, _ = _d2_case("c deep codes", deep, deep_ids.size,
                                      dev)
    d2_err = max(d2_err, err)
    on_cpu = hufdec.decode_payload_device(*deep, deep_ids.size, device="cpu")
    check((on_cpu is None) == declined,
          "D2 and its plain version on the CPU disagree on the deep stream")
    print(f"  D2 (c deep codes): the card and the CPU plain version both "
          f"{'decline' if declined else 'decode'}")

    one_pass = lambda: bitpack.pack_words(*d1_ops, n_words)  # noqa: E731
    per_symbol = lambda: bitpack.pack_words(  # noqa: E731
        *d1_ops, n_words, one_pass=False)
    (o1, o2), (n1, n2) = _pair_turns(per_symbol, one_pass, sz["iters"], dev)
    d1 = {"ms_per_symbol": (o1 + o2) / 2,
          "alone_ms": _kernels_ms(one_pass, ("pack_tiles_kernel",
                                             "book_kernel"), dev),
          "alone_ms_per_symbol": _kernels_ms(per_symbol, ("pack_kernel",),
                                             dev),
          "device_split_ms": _device_split(one_pass, dev)}
    print(f"  time D1 schedules ({d1_ops[0].shape[0]} x {d1_ops[0].shape[1]} "
          f"ids) on {card}: one thread a symbol {o1:.4f} / {o2:.4f} ms, one "
          f"pass {n1:.4f} / {n2:.4f} ms a call by events (old, new, new, "
          f"old); kernels alone (profiler) {d1['alone_ms_per_symbol']:.4f} "
          f"and {d1['alone_ms']:.4f} ms, "
          f"{d1['alone_ms_per_symbol'] / d1['alone_ms']:.2f}x; bound "
          f"{d1_bound[0] * 1e3:.2f} us, roofline share of the one pass alone "
          f"{d1_bound[0] / d1['alone_ms']:.4f}")
    print("  D1, one pass: everything a call puts on the card (profiler, "
          "ms): " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
              d1["device_split_ms"].items(), key=lambda kv: -kv[1])))
    timings = {
        "D1": _time_turns(one_pass,
                          lambda: bitpack.pack_words_ref(*d1_ops, n_words),
                          sz["iters"], dev),
        "D2": _time_turns(lambda: hufdec.walk(*d2_ops),
                          lambda: hufdec.walk_ref(*d2_ops),
                          sz["iters"], dev)}
    d2 = _d2_timings(d2_ops, d2_pass2, dev, card, sz)
    t_check = _time_ms(lambda: bitpack._check(*d1_ops), sz["iters"], dev)
    print(f"  D1's input checks alone (one host sync): {t_check:.4f} ms")
    for name, shape, (b_ms, b_by) in (
            ("D1", f"{d1_ops[0].shape[0]} x {d1_ops[0].shape[1]} ids",
             d1_bound),
            ("D2", f"pass 1, {d2_ops[2].numel()} lanes", d2_bound)):
        (k1, k2), (p1, p2) = timings[name]
        timings[name] = ((k1, k2), (p1, p2), b_ms, b_by)
        print(f"  time {name} ({shape}) on {card}: kernel {k1:.4f} / "
              f"{k2:.4f} ms per launch, plain version {p1:.1f} / {p2:.1f} ms "
              f"(plain, kernel, kernel, plain); bound {b_ms * 1e3:.3f} us "
              f"({b_by}), roofline share {2 * b_ms / (k1 + k2):.5f}")

    # the whole routes against the C paths on the same streams (host clock)
    books = [huffman.build_codebook(s[1]) for s in stats]
    arrays = huffman.batch_arrays([s[2] for s in stats],
                                  [s[1] for s in stats], books)
    t0 = time.perf_counter()
    for s, b in zip(stats, books):
        native.pack_bits(b.codes, b.lens, s[2])
    t_cpack = (time.perf_counter() - t0) * 1e3
    bitpack.pack_bits_batch(*arrays, device=dev)  # warm
    t0 = time.perf_counter()
    bitpack.pack_bits_batch(*arrays, device=dev)
    t_dpack = (time.perf_counter() - t0) * 1e3
    n = stats[0][2].size
    t0 = time.perf_counter()
    native.huf_decode(huf[0], *huf[1:], 0, n)
    t_cdec = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hufdec.decode_payload_device(*huf, n, device=dev)
    t_ddec = (time.perf_counter() - t0) * 1e3
    print(f"  routes on the 1024^2 Hufman streams: pack 8 streams C "
          f"{t_cpack:.2f} ms, pack_bits_batch (D1 route) {t_dpack:.2f} ms; "
          f"decode 1 stream C {t_cdec:.2f} ms, decode_payload_device (D2 "
          f"route) {t_ddec:.2f} ms")
    return {"D1": (d1_err, timings["D1"]), "D2": (d2_err, timings["D2"]),
            "D1 check ms": t_check, "D1 schedules": d1, "D2 passes": d2,
            "routes ms": {"pack_c_8": t_cpack, "pack_d1_8": t_dpack,
                          "decode_c_1": t_cdec, "decode_d2_1": t_ddec}}


def _d2_timings(d2_ops, d2_pass2, dev, card, sz):
    """D2's two passes on the 1024^2 Hufman payload at K = 0 and the
    default K, in turns (K 0, K, K, 0) through the wrapper (CUDA events) and
    the kernels alone (profiler), and the plain pass 2."""
    (args, out_start, n), (b2_ms, b2_by) = d2_pass2
    kd = hufdec.TABLE_BITS
    passes = {
        "pass 1": lambda K: hufdec.walk(*d2_ops, K=K),
        "pass 2": lambda K: hufdec.walk(*args, out_start=out_start,
                                        n_symbols=n, K=K)}
    keys = {0: ("walk_kernel",), kd: ("walk_kernel", "table_kernel")}
    out = {"K": kd, "bound_ms_pass2": b2_ms, "bound_by_pass2": b2_by}
    for name, fn in passes.items():
        (z1, z2), (t1, t2) = _pair_turns(lambda: fn(0), lambda: fn(kd),
                                         sz["iters"], dev)
        dz = _kernels_ms(lambda: fn(0), keys[0], dev)
        dt = _kernels_ms(lambda: fn(kd), keys[kd], dev)
        key = name.replace(" ", "")
        out.update({f"ms_{key}": (t1 + t2) / 2, f"ms_{key}_k0": (z1 + z2) / 2,
                    f"device_ms_{key}": dt, f"device_ms_{key}_k0": dz})
        print(f"  time D2 {name} on {card}: K = 0 {z1:.4f} / {z2:.4f} ms, "
              f"K = {kd} {t1:.4f} / {t2:.4f} ms per call (K 0, K, K, 0); "
              f"kernels alone (profiler) {dz:.4f} and {dt:.4f} ms, "
              f"{dz / dt:.2f}x")
    t0 = time.perf_counter()
    hufdec.walk_ref(*args, out_start=out_start, n_symbols=n)
    _sync(dev)
    out["plain_ms_pass2"] = (time.perf_counter() - t0) * 1e3
    print(f"  D2 pass 2 ({args[2].numel()} lanes): plain version "
          f"{out['plain_ms_pass2']:.1f} ms; bound {b2_ms * 1e3:.3f} us "
          f"({b2_by}), roofline share {b2_ms / out['device_ms_pass2']:.5f} "
          "of the kernels alone")
    return out


# ---------------------------------------------------------------------------
# phase 4 and 5
# ---------------------------------------------------------------------------

def run_codec(spec, paths, dev, out_dir):
    """runner.measure_all through the normal entry point, recording the
    streams and fused MSEs it produced."""
    codec = from_spec(spec, device=dev.type)
    rec = {"blobs": [], "fused_mses": [], "fused_calls": 0}
    encode_batch = codec.encode_batch

    def recording_encode_batch(imgs):
        out = encode_batch(imgs)
        rec["blobs"].extend(out)
        return out

    codec.encode_batch = recording_encode_batch
    fused = getattr(codec, "decode_mse_batch", None)
    if fused is not None:
        def recording_decode_mse_batch(blobs, originals):
            rec["fused_calls"] += 1
            mses, fetch = fused(blobs, originals)
            rec["fused_mses"].extend(mses)
            return mses, fetch

        codec.decode_mse_batch = recording_decode_mse_batch
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = runner.measure_all(codec, paths, output_dir=out_dir,
                                 verbose=False, batch=8)
    rec["fallbacks"] = out.getvalue().count("falling back to per-image decode")
    return codec, res, rec


def _measured(spec, paths, dev, card, out_dir):
    """One runner.measure_all run of `spec`, checked and printed."""
    codec, res, rec = run_codec(spec, paths, dev, out_dir)
    check(res.failures == [], f"{spec}: failures {res.failures}")
    check(len(res.rows) == len(paths), f"{spec}: {len(res.rows)} rows")
    with open(os.path.join(out_dir, f"{codec.name}.csv")) as fh:
        n_csv = len(fh.read().splitlines()) - 1
    check(n_csv == len(paths), f"{spec}: {n_csv} CSV rows")
    check(rec["fallbacks"] == 0,
          f"{spec}: the runner fell back to per-image decode")
    check(all(math.isfinite(r[3]) and r[1] > 0 for r in res.rows),
          f"{spec}: a row is not finite")
    check(len(rec["blobs"]) == len(paths), f"{spec}: streams not recorded")
    if codec.is_lossless:
        check(all(r[3] == 0.0 for r in res.rows), f"{spec}: lossy rows")
    if isinstance(codec, VoronoiCluster):
        check(rec["fused_calls"] > 0, "the fused voronoi decode never ran")
        check(rec["fused_mses"] == [r[3] for r in res.rows],
              "fused MSEs differ from the CSV rows")
    dec_mps = res.megapixels / res.decode_s if res.decode_s else 0.0
    gate = ",".join(g for g in GATES + HUF_GATES
                    if os.environ.get(g) == "1") or "no gate"
    print(f"  {spec} ({gate}) on {card}: encode {res.encode_mps:.3f} MP/s, "
          f"decode {dec_mps:.3f} MP/s ({res.megapixels:.3f} MP); mean ratio "
          f"{res.mean_ratio:.4f}%, mean MSE {res.mean_error:.4f}; fused "
          f"decode calls {rec['fused_calls']}, fallbacks {rec['fallbacks']}")
    return codec, res, rec


@contextlib.contextmanager
def gate(name):
    """Set one of the Hilbert codec's env gates for the duration."""
    old = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _colour_hist_case(imgs, runs, dev, card):
    """cluster-colors' device path on phase 4's images: one upload and one
    sort (`ops/color_hist.py`) give each image's `native.hist_rgb` exactly,
    and the streams the runner's `encode_batch` made on the card equal the
    CPU path's; then the device histogram and the host C histograms of the
    images timed in turns (host, device, device, host)."""
    lh = color_hist.lane_histograms(imgs, dev)
    for b, im in enumerate(imgs):
        uniq, counts, inverse = native.hist_rgb(pixels_row_major(im))
        colors, got_counts, got_inverse = lh.lane(b)
        check(np.array_equal(histogram.pack_colors(colors), uniq)
              and np.array_equal(got_counts, counts)
              and np.array_equal(got_inverse, inverse),
              f"the device colour histogram of image {b} differs from "
              "native.hist_rgb")
    spec = SPECS[0]
    cpu = from_spec(spec, device="cpu").encode_batch(imgs)
    check(runs[spec][2]["blobs"] == cpu,
          f"{spec}: the streams on {dev.type} differ from the CPU path's")
    (h1, h2), (d1, d2) = _pair_turns(
        lambda: [histogram.color_histogram(pixels_row_major(im))
                 for im in imgs],
        lambda: color_hist.lane_histograms(imgs, dev), 3, dev)
    mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
    print(f"  colour histograms of the {len(imgs)} images ({mp:.3f} MP, "
          f"{sum(lh.ns)} unique colours) on {dev.type}: equal to "
          f"native.hist_rgb image by image; {spec}'s {len(cpu)} streams "
          f"equal the CPU path's. One upload and sort {d1:.3f} / {d2:.3f} ms "
          f"against the host C histograms' {h1:.3f} / {h2:.3f} ms in turns "
          f"on {card}")


def phase_main_path(imgs, paths, dev, card, out_dir):
    print("phase 4: the main paths, runner.measure_all(from_spec(spec, "
          f"device={dev.type!r}), {len(paths)} PNGs, batch=8)")
    runs = {}
    k1, d3 = kmeans_kernel.assign_stats, kmeans_kernel.step_update
    k1.launches = d3.launches = 0
    every = km._CHECK_EVERY
    for spec in SPECS:
        before = (k1.launches, d3.launches)
        with kmeans_profile.IterLog() as log:
            runs[spec] = _measured(spec, paths, dev, card, out_dir)
        n_k1, n_d3 = k1.launches - before[0], d3.launches - before[1]
        print(f"  {spec}: {log.loops} k-means loops of {log.iters} "
              f"iterations in all, K1 launches {n_k1} (one an iteration, "
              f"enqueued {every} at a time), D3 launches {n_d3} (the update "
              f"runs in K1's last blocks), host checks of the loops "
              f"{n_k1 // every}")
        if dev.type == "cuda":
            check(n_d3 == 0, f"{spec}: D3 launched alone on the default path")
            check(n_k1 % every == 0
                  and log.iters <= n_k1 < log.iters + every * log.loops,
                  f"{spec}: {n_k1} K1 launches for {log.iters} iterations in "
                  f"{log.loops} loops")
    _colour_hist_case(imgs, runs, dev, card)
    # D3 is on the path inside K1's launches, never as a launch of its own
    launches = {"K1": k1.launches, "D3": d3.launches}
    print(f"  K1 launches over the k-means path: {launches['K1']} (D3 in "
          f"each), D3 launches of its own {launches['D3']}")
    windows = {}
    if dev.type == "cuda":
        for spec in SPECS:
            win = kmeans_profile.encode_window(from_spec(spec, device="cuda"),
                                               imgs[:8])
            windows[spec] = win
            print(f"  profiler, one warm {spec} encode_batch of 8 images on "
                  f"{card}: {win['wall_s']:.4f} s, device busy share "
                  f"{win['busy_share']:.4f}, K1 (D3 in it) "
                  f"{win['k1_share']:.4f}; {win['kernels']} kernels, "
                  f"{win['iterations']} iterations, "
                  f"{win['kernels_per_iteration']:.2f} kernels an iteration")
            check(win["device_events"] > 0,
                  f"the profiler saw no device activity in {spec}")
            check(win["d3_launches"] == 0 and win["d3_share"] == 0,
                  f"{spec}: D3 ran as a kernel of its own in the window")

    for spec in HILBERT_SPECS:
        runs[spec] = _measured(spec, paths, dev, card, out_dir)
    for name, counter, chunk in (
            ("K2", approx_rle.wide_records, approx_rle.WIDE_CHUNK),
            ("K3", approx_rle.batch_records, approx_rle.CHUNK)):
        gate_name = GATES[0] if name == "K2" else GATES[1]
        counter.launches = counter.kernel_launches = 0
        with gate(gate_name):
            runs[(GATED, gate_name)] = _measured(
                GATED, paths, dev, card, f"{out_dir}_{gate_name.lower()}")
        launches[name] = counter.launches
        launches[f"{name} kernels"] = counter.kernel_launches
        print(f"  {name} launches over {GATED} under {gate_name}=1: "
              f"{launches[name]} calls, {counter.kernel_launches} kernel "
              f"launches (chunks of {chunk})")
    chunked = runs[(GATED, GATES[0])][2]["blobs"]
    check(chunked == runs[GATED][2]["blobs"],
          f"{GATED}: the chunked route's streams differ from the ungated ones")
    print(f"  {GATED}: the {len(chunked)} streams of the chunked route equal "
          "the ungated streams byte for byte")

    for spec in HOST_SPECS:
        runs[spec] = _measured(spec, paths, dev, card, out_dir)
    for name, gate_name, counter in (("D1", HUF_GATES[0], bitpack.pack_words),
                                     ("D2", HUF_GATES[1], hufdec.walk)):
        counter.launches = 0
        hufdec.root_table.launches = 0
        hufdec.declines = 0
        with gate(gate_name):
            for spec in HUF_SPECS:
                runs[(spec, gate_name)] = _measured(
                    spec, paths, dev, card, f"{out_dir}_{gate_name.lower()}")
        launches[name] = counter.launches
        table = (f" (and {hufdec.root_table.launches} root-table launches, "
                 f"K = {hufdec.TABLE_BITS})" if name == "D2" else "")
        print(f"  {name} launches over {', '.join(HUF_SPECS)} under "
              f"{gate_name}=1: {launches[name]}{table}; D2 declines "
              f"{hufdec.declines}")
        for spec in HUF_SPECS:
            _, res, rec = runs[(spec, gate_name)]
            check(rec["blobs"] == runs[spec][2]["blobs"],
                  f"{spec} under {gate_name}: streams differ from the "
                  "ungated ones")
            check([r[3] for r in res.rows] == [r[3] for r in runs[spec][1].rows],
                  f"{spec} under {gate_name}: MSEs differ from the ungated "
                  "ones")
        if name == "D2":
            check(hufdec.declines == 0, "D2 declined on the suite images")
            launches["D2 root table"] = hufdec.root_table.launches
    print(f"  {', '.join(HUF_SPECS)}: the streams and MSEs under both Huffman "
          "gates equal the ungated ones")
    print(f"  gated routes beside the ungated ones on {card} (encode / decode "
          "MP/s):")
    for spec, gates in ((GATED, GATES), ("hufman", HUF_GATES),
                        ("delta", HUF_GATES)):
        row = [("no gate", runs[spec][1])] + [
            (g, runs[(spec, g)][1]) for g in gates]
        print(f"    {spec}: " + "; ".join(
            f"{g} {r.encode_mps:.3f} / "
            f"{(r.megapixels / r.decode_s if r.decode_s else 0.0):.3f}"
            for g, r in row))
    if dev.type == "cuda":
        for name, n in launches.items():
            check(n > 0 or name == "D3",
                  f"{name} never launched on its main path")
    return runs, launches, windows


def phase_card_vs_cpu(imgs, runs, dev, crop):
    print(f"phase 5: {dev.type} against the CPU path")
    crops = [np.ascontiguousarray(im[:crop, :crop]) for im in imgs[:2]]
    cases = ([(s, None) for s in SPECS] + [(GATED, g) for g in GATES]
             + [(s, g) for g in HUF_GATES for s in HUF_SPECS])
    for spec, gate_name in cases:
        with gate(gate_name) if gate_name else contextlib.nullcontext():
            t0 = time.perf_counter()
            on_dev = from_spec(spec, device=dev.type).encode_batch(crops)
            t1 = time.perf_counter()
            on_cpu = from_spec(spec, device="cpu").encode_batch(crops)
            t2 = time.perf_counter()
            if gate_name == HUF_GATES[1]:
                for data in on_dev:
                    check(np.array_equal(
                        from_spec(spec, device=dev.type).decode(data),
                        from_spec(spec, device="cpu").decode(data)),
                        f"{spec} ({gate_name}): {dev.type} and CPU decodes "
                        "differ")
        check(on_dev == on_cpu, f"{spec} ({gate_name}): {dev.type} and CPU "
              "streams differ")
        print(f"  {spec}{f' under {gate_name}=1' if gate_name else ''}: "
              f"{len(crops)} crops of {crop}^2, identical streams "
              f"({[len(s) for s in on_dev]} B; {dev.type} {t1 - t0:.2f} s, "
              f"CPU {t2 - t1:.2f} s)")
    _, res, rec = runs["voronoi(128)"]
    cpu = VoronoiCluster(128, device="cpu")
    cpu_mses = [runner.compute_error(im, cpu.decode(b))
                for im, b in zip(imgs, rec["blobs"])]
    check(cpu_mses == rec["fused_mses"],
          f"CPU decode MSEs {cpu_mses} != fused MSEs {rec['fused_mses']}")
    print(f"  voronoi(128): {len(cpu_mses)} full-size streams decoded on the "
          "CPU give the fused MSEs exactly")
    if dev.type == "cuda":  # hours on the CPU's plain version
        img = synth_natural(np.random.default_rng(42), 2160, 3840)
        t0 = time.perf_counter()
        data = from_spec("voronoi(128)", device="cuda").encode(img)
        t1 = time.perf_counter()
        check(hashlib.sha256(data).hexdigest() == VORONOI_4K_SHA,
              "voronoi(128) of the golden 3840x2160 image: the card's stream "
              "does not hash to the pinned one")
        print(f"  voronoi(128): the golden 3840x2160 image (K1's unpacked "
              f"path, 8.3M points) encodes on the card to the pinned stream "
              f"({len(data)} B, sha {VORONOI_4K_SHA[:6]}..., {t1 - t0:.2f} s)")


# ---------------------------------------------------------------------------
# phase 6: the multi-device layer and entry()
# ---------------------------------------------------------------------------

def voronoi_points(img) -> np.ndarray:
    """The (x, y, r, g, b) points of an image, row-major: int32[h*w, 5]."""
    h, w = img.shape[:2]
    idx = np.arange(h * w, dtype=np.int32)
    return np.concatenate([np.stack([idx % w, idx // w], axis=1),
                           img.reshape(-1, 3).astype(np.int32)], axis=1)


@contextlib.contextmanager
def timed_drive(dev, out: list):
    """Appends each k-means loop's milliseconds (`km._drive`, host checks
    included) to `out` for the duration, on the clock `sharded_kmeans`
    times its loop with (`mesh.Clock`: CUDA events on the card)."""
    from cniic_tpu_torch.parallel import mesh

    real = km._drive

    def drive(*args, **kwargs):
        clock = mesh.Clock(dev)
        clock.mark()
        r = real(*args, **kwargs)
        clock.mark("loop")
        out.append(clock.parts_ms()["loop"])
        return r

    km._drive = drive
    try:
        yield out
    finally:
        km._drive = real


# the sharded iteration's parts on the card, from the kernels' names
ITERATION_PARTS = (("K1", "assign_stats"), ("D3", "step_update"),
                   ("all-reduce", "AllReduce"))
# the uploads, the host checks' and the result's reads, the result's gather
SET_UP = ("Memcpy HtoD", "Memcpy DtoH", "AllGather", "Memset")


def iteration_split(group, pts, k, dev, iters: int, card: str) -> dict:
    """Device ms an iteration of a warm `sharded_kmeans` call on the card,
    by part (profiler): K1, D3, the all-reduce, the candidate gather and
    the buffer copies (every other kernel of the loop), and the idle gaps
    (the loop's time on the card's clock less all of these: the card
    waiting for the host to issue work or for the collective's stream),
    beside the host's time an iteration less its waits for the checks. The uploads,
    read-backs and the closing all-gather are left out. An NCCL world of 1
    launches no all-reduce kernel. {} in a rehearsal."""
    from cniic_tpu_torch.parallel import mesh

    stats = {}
    split = _device_split(
        lambda: mesh.sharded_kmeans(group, pts, k, device=dev.type,
                                    stats=stats), dev, calls=1)
    if not split:
        print("  the sharded iteration's split: not measured (no card)")
        return {}
    parts = {part: 0.0 for part, _ in ITERATION_PARTS}
    parts["candidates and copies"] = 0.0
    for name, ms in split.items():
        part = next((p for p, key in ITERATION_PARTS if key in name), None)
        if part is None and not any(key in name for key in SET_UP):
            part = "candidates and copies"
        if part is not None:
            parts[part] += ms
    check(stats["iters"] == iters, "the profiled sharded_kmeans call ran "
          f"{stats['iters']} iterations, not {iters}")
    per = {p: ms / iters for p, ms in parts.items()}
    per["idle gaps"] = (stats["loop_ms"] - sum(parts.values())) / iters
    per["loop"] = stats["loop_ms"] / iters
    host = stats["host_ms"] / iters
    print(f"  the sharded iteration on {card}, an NCCL world of 1, device ms "
          "an iteration by the profiler: "
          + ", ".join(f"{p} {v:.4f}" for p, v in per.items())
          + "; by CUDA events between the loop's marks: "
          + ", ".join(f"{p} {v / iters:.4f}"
                      for p, v in stats["parts_ms"].items())
          + f"; the host issues it in {host:.4f} ms")
    return {"device_ms_per_iteration": per, "host_ms_per_iteration": host,
            "events_ms_per_iteration": {p: v / iters for p, v in
                                        stats["parts_ms"].items()},
            "kernels_ms": split}


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _sharded_twice(group, pts, k, device):
    """`sharded_kmeans` twice: the first call pays for the set-up (NCCL
    makes its communicator at the first collective, kernels load at their
    first launch), the second runs warm. Returns (centroids, assignment
    digest, iterations, warm stats, first call's stats) of the warm call,
    which must equal the first's."""
    from cniic_tpu_torch.parallel import mesh

    runs = []
    for _ in range(2):
        stats = {}
        c, a, it = mesh.sharded_kmeans(group, pts, k, device=device,
                                       stats=stats)
        runs.append((c, _digest(a), it, stats))
    (c0, a0, i0, first), (c, a, it, warm) = runs
    check(i0 == it and a0 == a and np.array_equal(c0, c),
          "sharded_kmeans gave two results on the same input")
    return c, a, it, warm, first


def _mesh_rank(pts, k, imgs, device):
    """Phase 6 on one rank of a group whose ranks share the card (gloo):
    the point-sharded k-means, then the lane-sharded encodes with the fused
    voronoi decode + MSE, each with the kernel counts it launched."""
    from cniic_tpu_torch.parallel import mesh

    group = mesh.make_mesh()
    k1, d3 = kmeans_kernel.assign_stats, kmeans_kernel.step_update
    k1.launches = d3.launches = 0
    out = {"kmeans": _sharded_twice(group, pts, k, device),
           "kmeans launches": (k1.launches, d3.launches), "encodes": {}}
    k1.launches = d3.launches = 0
    for spec in SPECS:
        codec = from_spec(spec, device=device)
        t0 = time.perf_counter()
        blobs = codec.encode_batch(imgs)
        t1 = time.perf_counter()
        fused = getattr(codec, "decode_mse_batch", None)
        mses = fused(blobs, imgs)[0] if fused is not None else None
        out["encodes"][spec] = (blobs, mses, t1 - t0)
    out["encode launches"] = (k1.launches, d3.launches)
    return out


def phase_multi_device(imgs, runs, dev, card, sz):
    """Phase 6 (see the module docstring); returns the path's launches."""
    import torch.distributed as dist

    from cniic_tpu_torch import entry
    from cniic_tpu_torch.parallel import launch, mesh

    h, w = sz["mesh_img"]
    k = sz["mesh_k"]
    img = synth_natural(np.random.default_rng(42), h, w)
    pts = voronoi_points(img)
    print(f"phase 6: the multi-device layer on {card}: sharded_kmeans over "
          f"the {w}x{h} image's {len(pts)} voronoi points (d = 5, k = {k})")
    k1, d3 = kmeans_kernel.assign_stats, kmeans_kernel.step_update
    k1.launches = d3.launches = 0
    loops = []
    with timed_drive(dev, loops):
        want = km.kmeans(pts, k, device=dev.type)
    single_ms = loops[0] / max(want[2], 1)
    print(f"  one device (km.kmeans): {want[2]} iterations, "
          f"{single_ms:.4f} ms an iteration ({loops[0]:.2f} ms the loop)")
    launches = {"one device": (k1.launches, d3.launches)}

    def same(name, c, digest, it, stats, first):
        err = int(np.abs(c - want[0]).max())
        check(it == want[2] and digest == _digest(want[1]) and err == 0,
              f"sharded_kmeans ({name}) differs from km.kmeans: {it} "
              f"iterations against {want[2]}, centroids max |err| {err}, "
              f"assignment {'equal' if digest == _digest(want[1]) else 'differs'}")
        per = stats["loop_ms"] / max(it, 1)
        print(f"  sharded_kmeans, {name}: equal to km.kmeans (centroids, "
              f"assignment, {it} iterations); {per:.4f} ms an iteration "
              f"({per / single_ms:.2f}x one device's), the collectives "
              f"{stats['collective_ms']:.2f} ms of the loop's "
              f"{stats['loop_ms']:.2f} ms (share "
              f"{stats['collective_ms'] / stats['loop_ms']:.4f}, "
              f"{stats['collectives']} all-reduces); its first call "
              f"{first['loop_ms'] / max(it, 1):.4f} ms an iteration, the "
              f"collectives {first['collective_ms']:.2f} of "
              f"{first['loop_ms']:.2f} ms (set-up included); the host "
              f"issues an iteration in {stats['host_ms'] / max(it, 1):.4f} "
              "ms (its waits for the checks left out)")
        return {"ms_per_iteration": per,
                "host_ms_per_iteration": stats["host_ms"] / max(it, 1),
                "first_call_ms_per_iteration": first["loop_ms"] / max(it, 1),
                "first_call_collective_ms": first["collective_ms"],
                "collective_share": stats["collective_ms"] / stats["loop_ms"],
                "collective_ms": stats["collective_ms"],
                "loop_ms": stats["loop_ms"], "iterations": it}

    backend1 = "nccl" if dev.type == "cuda" else "gloo"
    timings = {"one device ms_per_iteration": single_ms}
    k1.launches = d3.launches = 0
    group = mesh.make_mesh(1, device=dev.type)
    try:
        timings[f"world 1 {backend1}"] = same(
            f"a world of 1 under {backend1}",
            *_sharded_twice(group, pts, k, dev.type))
        launches[f"world 1 {backend1}"] = (k1.launches, d3.launches)
        timings[f"world 1 {backend1}"]["split"] = iteration_split(
            group, pts, k, dev, want[2], card)
        k1.launches = d3.launches = 0
        t0 = time.perf_counter()
        entry.dryrun_multichip(1, device=dev.type)
        print(f"  dryrun_multichip(1, device={dev.type!r}) under "
              f"{backend1}: passed ({time.perf_counter() - t0:.2f} s)")
        launches["dryrun_multichip(1)"] = (k1.launches, d3.launches)
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    ranks = launch.run(2, _mesh_rank, (pts, k, imgs[:8], dev.type),
                       device=dev.type, backend="gloo")
    print(f"  a world of 2 under gloo on the one {dev.type} device: two "
          f"ranks spawned, run and joined in {time.perf_counter() - t0:.1f} s")
    for r, out in enumerate(ranks):
        key = f"world 2 gloo rank {r}"
        timings[key] = same(f"rank {r} of 2 under gloo", *out["kmeans"])
        launches[key] = out["kmeans launches"]
        for spec in SPECS:
            blobs, mses, secs = out["encodes"][spec]
            _, res, rec = runs[spec]
            check(blobs == rec["blobs"][:len(blobs)],
                  f"{spec}: rank {r}'s lane-sharded streams differ from "
                  "the single-device ones")
            if mses is not None:
                check(mses == rec["fused_mses"][:len(mses)],
                      f"{spec}: rank {r}'s sharded fused MSEs differ")
            print(f"  {spec} encode_batch of {len(blobs)} images, rank {r} "
                  f"of 2 (gloo): streams{' and fused MSEs' if mses else ''} "
                  f"equal the single-device ones ({secs:.2f} s)")
        launches[f"world 2 gloo rank {r} encodes"] = out["encode launches"]

    k1.launches = d3.launches = 0
    fn, args = entry.entry(device=dev.type)
    got = fn(*args)
    launches["entry"] = (k1.launches, d3.launches)
    cpu_fn, cpu_args = entry.entry(device="cpu")
    ref = cpu_fn(*cpu_args)
    err = max(_max_err(got[1:], ref[1:]), abs(got[0] - ref[0]))
    print(f"  entry(): fn(*args) on {dev.type} ({got[0]} iterations, "
          f"{launches['entry'][0]} K1 launches) against its CPU run: max "
          f"|err| of it, cur, cents, moved, best, stall = {err}")
    check(err == 0, "entry()'s fn on the card differs from its CPU run")
    sharded = [f"world 1 {backend1}"] + [
        f"world 2 gloo rank {r}{part}" for r in range(len(ranks))
        for part in ("", " encodes")]
    total = tuple(sum(launches[n][i] for n in sharded) for i in (0, 1))
    print(f"  K1 / D3 launches on the sharded paths: {total[0]} / {total[1]}"
          f" ({'; '.join(f'{n} {a} / {b}' for n, (a, b) in launches.items())})")
    if dev.type == "cuda":
        for name in (f"world 1 {backend1}", "world 2 gloo rank 0",
                     "world 2 gloo rank 1"):
            check(min(launches[name]) > 0,
                  f"K1 or D3 never launched on the sharded path ({name})")
    return {"launches": launches, "total": total, "timings": timings}


# ---------------------------------------------------------------------------
# phase 7: the experiment layer
# ---------------------------------------------------------------------------

def _k1_branch(codec, img_shape, dev) -> str:
    """Which of K1's branches a k-means codec's step takes on an image."""
    h, w = img_shape
    pmax = ((w - 1, h - 1, 255, 255, 255) if isinstance(codec, VoronoiCluster)
            else (255, 255, 255))
    path = ("packed" if kmeans_kernel.packed_path(pmax, codec.n)
            else "unpacked")
    if dev.type != "cuda":
        return path
    smem = kmeans_kernel.stats_in_smem(len(pmax), codec.n)
    return f"{path}, {'shared-memory' if smem else 'global'} statistics"


def _quiet(fn, *args, **kw):
    """Run fn with its standard output captured; returns (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = fn(*args, **kw)
    return got, buf.getvalue()


def phase_experiment(dev, card, sz, tmp):
    """Phase 7 (see the module docstring); returns K1's and D3's launches
    over the sweep and each k-means config's iterations, launches, seconds
    and K1 branch."""
    rehearse = dev.type != "cuda"
    corpus = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    args = ([corpus, str(sz["exp_n"]), str(sz["exp_side"])] if rehearse
            else [corpus, str(sz["exp_n"]), "--midtex"])
    _quiet(synth_corpus.main, args)
    paths = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
    check(len(paths) == sz["exp_n"], f"synth_corpus made {len(paths)} images")
    shape = load_image(paths[0]).shape[:2]
    print(f"phase 7: the experiment layer on {card}")
    print(f"  (a) synth_corpus {' '.join(args[1:])}: {len(paths)} images of "
          f"{shape[1]}x{shape[0]} in {time.perf_counter() - t0:.1f} s")

    k1, d3 = kmeans_kernel.assign_stats, kmeans_kernel.step_update
    counters = {"K1": k1, "D3": d3, "K2": approx_rle.wide_records,
                "K3": approx_rle.batch_records, "D1": bitpack.pack_words,
                "D2": hufdec.walk}
    per = {}
    measure_all = runner.measure_all

    def traced(codec, paths, **kw):
        if not isinstance(codec, (ClusterColors, VoronoiCluster)):
            return measure_all(codec, paths, **kw)
        before = (k1.launches, d3.launches, log.iters, log.loops,
                  k1.pruned_launches)
        t1 = time.perf_counter()
        res = measure_all(codec, paths, **kw)
        per[codec.name] = {
            "seconds": time.perf_counter() - t1,
            "iterations": log.iters - before[2], "loops": log.loops - before[3],
            "k1": k1.launches - before[0], "d3": d3.launches - before[1],
            "k1_pruned": k1.pruned_launches - before[4],
            "branch": _k1_branch(codec, shape, dev)}
        return res

    configs = sz["exp_configs"]
    out_dir = os.path.join(tmp, "sweep")
    argv = ([f"--device={dev.type}", "--batch=8", f"--out={out_dir}"]
            + ([f"--configs={','.join(configs)}"] if configs else []) + paths)
    results, seconds = {}, {}
    for c in counters.values():
        c.launches = 0
    k1.pruned_launches = 0
    runner.measure_all = traced
    try:
        with kmeans_profile.IterLog() as log:
            t0 = time.perf_counter()
            rc, text = _quiet(sweep.main, argv, results, seconds)
            wall = time.perf_counter() - t0
    finally:
        runner.measure_all = measure_all
    launches = {n: c.launches for n, c in counters.items()}
    launches["K1 pruned"] = k1.pruned_launches
    print(f"  (b) sweep.main({' '.join(argv[:3])} ...), overlapped, over "
          f"{len(paths)} images:")
    for line in text.splitlines():
        print(f"      {line}")
    check(rc == 0, f"the sweep failed (rc {rc})")
    dev_specs, host_specs = sweep.split_configs(configs)
    names = [from_spec(c, device="cpu").name for c in dev_specs + host_specs]
    if rehearse:
        print("  (c) no reference comparison in a rehearsal")
    else:
        diffs = sweep.diff_rows(out_dir, MIDTEX_REF, names,
                                images=[os.path.basename(p) for p in paths])
        for d in diffs:
            print(f"      differs: {d} (on {card})")
        check(not diffs, f"{len(diffs)} sweep rows differ from "
              "output_midtex's")
        print(f"  (c) all {len(names) * len(paths)} rows ({len(names)} CSVs x "
              f"{len(paths)} images): compressed_size, compression_ratio and "
              "error equal output_midtex's exactly")
    for name in (n for n in names if n in per):
        r = per[name]
        print(f"  (d) {name}: {r['iterations']} iterations in {r['loops']} "
              f"loops, K1 launches {r['k1']} ({r['branch']}; pruned "
              f"{r['k1_pruned']}), D3 launches {r['d3']}, "
              f"{r['seconds']:.1f} s on {card}")
        if dev.type == "cuda":
            check(r["k1"] > 0, f"{name}: K1 never launched on the device "
                  "queue")
    print(f"  (d) launches over the sweep: "
          + ", ".join(f"{n} {v}" for n, v in launches.items()))
    if dev.type == "cuda":
        check(launches["D3"] == 0, "D3 launched alone on the device queue")
        check(launches["K1 pruned"] > 0, "K1's pruned instance never "
              "launched on the device queue")
    serial = sum(seconds.values())
    print(f"  (e) on {card}: device queue {results['device']:.1f} s, host "
          f"queue {results['host']:.1f} s, total {wall:.1f} s overlapped; the "
          f"configs' times sum to {serial:.1f} s (the serial estimate)")

    ns_dir = os.path.join(tmp, "ns")
    t0 = time.perf_counter()
    _quiet(synth_corpus.main, [ns_dir, str(sz["ns_n"]), "--ns",
                               str(sz["ns_side"])])
    ns_paths = sorted(os.path.join(ns_dir, f) for f in os.listdir(ns_dir))
    made = time.perf_counter() - t0
    out = os.path.join(tmp, "northstar.json")
    t0 = time.perf_counter()
    rc, text = _quiet(northstar.main, [f"--device={dev.type}", "--chunk=8",
                                       f"--out={out}"] + ns_paths)
    check(rc == 0, f"northstar failed (rc {rc}):\n{text}")
    with open(out) as fh:
        ns = json.load(fh)
    print(f"  (f) northstar --chunk=8 over {len(ns_paths)} --ns images of "
          f"{sz['ns_side']}^2 (made in {made:.1f} s), every round trip "
          f"verified, {time.perf_counter() - t0:.1f} s on {card}: encode "
          f"geomean {ns['encode_geomean_mps']} MP/s, decode geomean "
          f"{ns['decode_geomean_mps']} MP/s, vs_baseline {ns['vs_baseline']} "
          f"({ns['baseline']})")
    for name in ns["per_codec_mps"]:
        print(f"      {name}: encode {ns['per_codec_mps'][name]} MP/s, "
              f"decode {ns['per_codec_decode_mps'][name]} MP/s")
    return {"launches": launches, "configs": per,
            "queues_s": {**results, "total": wall, "serial_sum": serial},
            "northstar": {k: ns[k] for k in (
                "encode_geomean_mps", "decode_geomean_mps", "per_codec_mps",
                "per_codec_decode_mps", "vs_baseline")}}


# ---------------------------------------------------------------------------
# phase 8: campaigns and profiles
# ---------------------------------------------------------------------------

def _last_json(text: str, prefix: str = "") -> dict:
    """The JSON object on the last line of a module's output (after
    `prefix`)."""
    last = text.strip().splitlines()[-1]
    check(last.startswith(prefix), f"no summary line: {last!r}")
    return json.loads(last[len(prefix):])


def _reprint(text: str, skip_last: bool = True) -> None:
    lines = text.strip().splitlines()
    for line in lines[:-1] if skip_last else lines:
        print(f"      {line}")


def phase_campaigns(paths, dev, card, sz, tmp):
    """Phase 8 (see the module docstring) over phase 4's PNGs `paths`;
    returns every kernel's launches over the phase and the two profiles'
    reports."""
    on_card = dev.type == "cuda"
    counters = {"K1": kmeans_kernel.assign_stats,
                "D3": kmeans_kernel.step_update, "K2": approx_rle.wide_records,
                "K3": approx_rle.batch_records, "D1": bitpack.pack_words,
                "D2": hufdec.walk}
    for c in counters.values():
        c.launches = 0
    out = os.path.join(tmp, "findings")
    print(f"phase 8: campaigns and profiles on {card}")

    t0 = time.perf_counter()
    argv = [f"--device={dev.type}", f"--seed={sz['fuzz_seed']}",
            f"--trials={sz['fuzz_trials']}", "--gates", "--against=cpu",
            f"--out={out}"]
    rc, text = _quiet(fuzz_campaign.main, argv)
    _reprint(text)
    fuzz = _last_json(text, "campaign done: ")
    check(rc == 0 and fuzz["findings"] == 0,
          f"the fuzz campaign has {fuzz['findings']} finding(s)")
    gated = [fuzz["families"][f"{s}+D2"] for s in fuzz_campaign.GATED]
    check(sum(f["d2_decodes"] for f in gated) > 0,
          "D2 decoded no mutated payload under the gate")
    check(sum(f["walk_launches"] for f in gated) > 0 or not on_card,
          "walk_kernel never launched under the gate")
    blobs = sum(f["trials"] for f in fuzz["families"].values())
    print(f"  (a) fuzz_campaign {' '.join(argv[1:5])}: {blobs} mutated "
          f"streams over {len(fuzz['families'])} families, 0 findings, every "
          f"outcome on {dev.type} equal to the CPU's (raised, or equal "
          f"pixels); D2 decoded "
          + ", ".join(f"{label} {f['d2_decodes']} (walk launches "
                      f"{f['walk_launches']})"
                      for label, f in fuzz["families"].items()
                      if "walk_launches" in f)
          + f"; {time.perf_counter() - t0:.1f} s")

    runs = {}
    for name, device, gates in (("card", dev.type, ""),
                                ("card, gated", dev.type, "k2,k3,d1,d2"),
                                ("cpu", "cpu", "")):
        t0 = time.perf_counter()
        rc, text = _quiet(roundtrip_campaign.main, [
            f"--device={device}", f"--seed={sz['rt_seed0']}",
            f"--trials={sz['rt_trials']}", f"--gates={gates}",
            f"--out={out}"])
        runs[name] = s = _last_json(text, "campaign done: ")
        check(rc == 0 and s["findings"] == 0,
              f"round trip ({name}): {s['findings']} finding(s):\n{text}")
        print(f"  (b) roundtrip_campaign --device={device} seeds "
              f"{sz['rt_seed0'] + 1}..{sz['rt_seed0'] + sz['rt_trials']} "
              f"gates {gates or 'none'}: {sum(s['trials'].values())} trials, "
              f"{sum(s['rejects'].values())} rejects, 0 findings, launches "
              f"{s['launches']}, {time.perf_counter() - t0:.1f} s")
    if on_card:
        check(runs["card"]["launches"]["K1"] > 0, "K1 never launched in the "
              "round trips")
        for name in ("K1", "K2", "K3", "D1", "D2"):
            check(runs["card, gated"]["launches"][name] > 0,
                  f"{name} never launched in the gated round trips")
    cpu = runs["cpu"]
    for name in ("card", "card, gated"):
        for spec in roundtrip_campaign.SPECS:
            check(runs[name]["streams_sha256"][spec]
                  == cpu["streams_sha256"][spec],
                  f"round trip ({name}): {spec}'s streams differ from the "
                  "CPU's")
            # under K3 the batch is held against K3's plain route in-run
            if not (name == "card, gated" and spec == "hilbert(rle(3))"):
                check(runs[name]["batch_sha256"][spec]
                      == cpu["batch_sha256"][spec],
                      f"round trip ({name}): {spec}'s batch streams differ "
                      "from the CPU's")
    print(f"  (b) the {len(roundtrip_campaign.SPECS)} specs' streams on "
          f"{dev.type}, gated and not, hash as the CPU's (sha256 per spec; "
          "under k3 hilbert(rle(3))'s batch lanes equal K3's plain route "
          "lane by lane)")

    rc, text = _quiet(profile_clusterc.main, [
        f"--device={dev.type}", f"--lanes={len(paths)}", "--chunks=1",
        "--k=32"] + paths)
    check(rc == 0, f"profile_clusterc failed:\n{text}")
    print(f"  (c) profile_clusterc over {len(paths)} images (phase 4's), k = "
          "32, stages in host seconds after a synchronize:")
    _reprint(text)
    clusterc = _last_json(text)
    rc, text = _quiet(kmeans_phase_probe.main, [f"--device={dev.type}"]
                      + paths)
    check(rc == 0, f"kmeans_phase_probe failed:\n{text}")
    print("  (c) kmeans_phase_probe over the same images (phases in host "
          "seconds, loop windows on the device's clock):")
    _reprint(text)
    phases = _last_json(text)
    launches = {n: c.launches for n, c in counters.items()}
    print("  launches over phase 8: "
          + ", ".join(f"{n} {v}" for n, v in launches.items()))
    if on_card:
        for name in ("K1", "K2", "K3", "D1", "D2"):
            check(launches[name] > 0, f"{name} never launched in phase 8")
    return {"launches": launches, "fuzz_blobs": blobs,
            "roundtrip_trials": sz["rt_trials"],
            "profile_clusterc": clusterc["groups"],
            "kmeans_phases": {
                spec: [{k: c[k] for k in ("lanes", "seconds", "iterations",
                                          "windows")} for c in calls]
                for spec, calls in phases["specs"].items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run the phases at a tiny size on the CPU with the "
                         "plain versions (no card, no kernel)")
    rehearse = ap.parse_args().rehearse_cpu
    sz = SIZES[rehearse]
    dev, card = phase_device(rehearse)
    phase_build(rehearse)
    kmeans_profile.keep_cupti()

    rng = np.random.default_rng(2024)
    imgs = [synth_image(rng, sz["side"], sz["side"]) for _ in range(8)]
    imgs.append(synth_image(rng, *sz["div2k"]))
    clock = [time.perf_counter()]

    def took(what):
        clock.append(time.perf_counter())
        print(f"  [{what} took {clock[-1] - clock[-2]:.1f} s]")

    max_err, d3_err, timings = phase_kernel(imgs, dev, card, sz)
    took("phase 3, K1 and D3")
    rle = phase_rle_kernels(imgs, dev, card, sz)
    took("phase 3, K2 and K3")
    huf = phase_huffman_kernels(imgs, dev, card, sz)
    took("phase 3, D1 and D2")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = []
        for i, im in enumerate(imgs):
            paths.append(os.path.join(tmp, f"img{i}_{im.shape[1]}x{im.shape[0]}.png"))
            save_png(im, paths[-1])
        runs, launches, windows = phase_main_path(
            imgs, paths, dev, card, os.path.join(tmp, "output"))
        took("phase 4")
        phase_card_vs_cpu(imgs, runs, dev, sz["crop"])
        took("phase 5")
        multi = phase_multi_device(imgs, runs, dev, card, sz)
        took("phase 6")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_exp_") as tmp7:
            exp = phase_experiment(dev, card, sz, tmp7)
        took("phase 7")
        camp = phase_campaigns(paths, dev, card, sz, tmp)
        took("phase 8")

    if dev.type == "cuda":
        print(run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).strip().splitlines()[0])
    else:
        print(card)
    # K1's row is the kernel the main path launches: K1 with D3 in each
    # lane's last block, alone by the profiler at (a), against K1's bound
    # plus D3's and against both plain versions; K1 without the update
    # beside it
    (ms, plain_ms, b_ms, b_by, dev_ms) = timings["a"]
    (ms_b, plain_ms_b, b_ms_b, _, dev_ms_b) = timings["b"]
    step_a, step_b = timings["step a"], timings["step b"]
    kernels = [{
        "id": "K1", "name": "kmeans_fused_step", "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches["K1"],
        "max_abs_err": max(max_err, d3_err),
        "ms": step_a["fused_alone_ms"], "plain_ms": step_a["plain_ms"],
        "bound_ms": step_a["bound_ms"], "bound_by": step_a["bound_by"],
        "library_ms": None, "call_ms": step_a["fused_call_ms"],
        "ms_cluster_colors": step_b["fused_alone_ms"],
        "plain_ms_cluster_colors": step_b["plain_ms"],
        "bound_ms_cluster_colors": step_b["bound_ms"],
        "without_update": {
            "name": "kmeans_assign_stats", "max_abs_err": max_err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "ms_cluster_colors": ms_b,
            "device_ms_cluster_colors": dev_ms_b,
            "plain_ms_cluster_colors": plain_ms_b,
            "bound_ms_cluster_colors": b_ms_b},
        "step": step_a, "step_cluster_colors": step_b,
        "launches_sharded": multi["total"][0],
        "launches_phase_6": {n: v[0] for n, v in multi["launches"].items()},
        "mesh": multi["timings"],
        "launches_phase_7": exp["launches"]["K1"],
        "phase_7": {"configs": exp["configs"], "queues_s": exp["queues_s"],
                    "northstar": exp["northstar"]}}]
    # D3 runs on the main path inside K1's launches and never as a launch of
    # its own: its time there is the one launch's less K1's, kernels alone
    d3_ms, d3_plain, d3_b, d3_by, d3_call = timings["D3"]
    kernels.append({
        "id": "D3", "name": "kmeans_step_update", "route": "cuda",
        "source": K1_SOURCE, "replaces": D3_REPLACES,
        "launches": launches["D3"], "launches_in_k1": launches["K1"],
        "max_abs_err": d3_err, "ms": step_a["fused_tail_ms"],
        "plain_ms": d3_plain, "bound_ms": d3_b, "bound_by": d3_by,
        "library_ms": None,
        "fused_tail_ms": step_a["fused_tail_ms"],
        "fused_tail_ms_cluster_colors": step_b["fused_tail_ms"],
        "alone_ms": d3_ms, "alone_call_ms": d3_call,
        "launches_sharded": multi["total"][1],
        "launches_phase_6": {n: v[1] for n, v in multi["launches"].items()},
        "launches_phase_7": exp["launches"]["D3"]})
    if windows:
        kernels[0]["encode_windows"] = {
            spec: {k: w[k] for k in ("wall_s", "busy_share", "k1_share",
                                     "kernels_per_iteration")}
            for spec, w in windows.items()}
    # K2's row: the chunk schedule the path launches, kernels alone by the
    # profiler at (a), beside the one walker timed in turns
    k2 = rle["K2"]
    b_ms, b_by = k2["bound"]
    kernels.append({
        "id": "K2", "name": "approx_rle_wide_chunked", "route": "cuda",
        "source": RLE_SOURCE, "replaces": K2_REPLACES,
        "launches": launches["K2"], "kernel_launches": launches["K2 kernels"],
        "max_abs_err": k2["err"], "ms": k2["alone_ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "roofline_share": b_ms / k2["alone_ms"],
        "chunk": k2["chunk"], "one_walker_ms": k2["one_walker_ms"],
        "seams": k2["seams"], "unsynced": k2["unsynced"],
        "rewalked": k2["rewalked"]})
    err, (k_ms, p_ms, kb_ms, kb_by) = rle["K3"]
    kernels.append({
        "id": "K3", "name": "approx_rle_batch", "route": "cuda",
        "source": RLE_SOURCE, "replaces": K3_REPLACES,
        "launches": launches["K3"], "max_abs_err": err, "ms": sum(k_ms) / 2,
        "plain_ms": sum(p_ms) / 2, "bound_ms": kb_ms, "bound_by": kb_by,
        "library_ms": None})
    full = rle["K3 full"]
    suite = full["8 x 1024^2 suite scans"]
    kernels[-1].update({
        "chunk": approx_rle.CHUNK, "kernel_launches": launches["K3 kernels"],
        "ms_one_walker": rle["K3 one-walker 8x16384 ms"],
        "ms_8x1024x1024": suite["ms"],
        "ms_8x1024x1024_one_walker": suite["one_walker_ms"],
        "bound_ms_8x1024x1024": full["bound"][0],
        "sync_share_8x1024x1024": (1 - suite["unsynced"] / suite["seams"]
                                   if suite["seams"] else 1.0),
        "settle_walked_8x1024x1024": suite["walked"],
        "device_ms_8x1024x1024": full.get("device_ms")})
    if "8 flat images" in full:
        kernels[-1].update({
            "ms_flat": full["8 flat images"]["ms"],
            "ms_flat_one_walker": full["8 flat images"]["one_walker_ms"]})
    for name, fn, replaces in (("D1", "huf_pack_tiles", D1_REPLACES),
                               ("D2", "huf_walk", D2_REPLACES)):
        err, (k_ms, p_ms, kb_ms, kb_by) = huf[name]
        kernels.append({
            "id": name, "name": fn, "route": "cuda", "source": HUF_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": sum(k_ms) / 2, "plain_ms": sum(p_ms) / 2,
            "bound_ms": kb_ms, "bound_by": kb_by, "library_ms": None})
    kernels[-2]["check_ms"] = huf["D1 check ms"]
    kernels[-2].update(huf["D1 schedules"])
    kernels[-1]["routes_ms"] = huf["routes ms"]
    kernels[-1].update(huf["D2 passes"])
    kernels[-1]["root_table_launches"] = launches["D2 root table"]
    for row in kernels:
        row["launches_phase_8"] = camp["launches"][row["id"]]
    # K1's pruned instance, the same kernel's instance for voronoi at large
    # k (phase 7's sweep drives it): over phase 3's whole loop at k = 2048,
    # alone by the profiler, beside the unpruned instance in turns
    pr = timings["pruned"]
    kernels.insert(1, {
        "id": "K1 pruned", "name": "kmeans_pruned_step", "route": "cuda",
        "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": exp["launches"]["K1 pruned"], "max_abs_err": pr["err"],
        "ms": pr["ms"], "plain_ms": pr["plain_ms"],
        "bound_ms": pr["bound_ms"], "bound_by": pr["bound_by"],
        "library_ms": None, "unpruned_ms": pr["unpruned_ms"],
        "scanned_share": pr["scanned_share"],
        "loop_iterations": pr["iterations"], "loop_launches": pr["launches"],
        "first_step_shares": pr["first_step_shares"]})
    kernels[0]["phase_8"] = {k: camp[k] for k in (
        "fuzz_blobs", "roundtrip_trials", "profile_clusterc",
        "kmeans_phases")}
    print(json.dumps({"kernels": kernels}))
    if dev.type == "cuda":
        kind, count, platform = (torch.cuda.get_device_name(0),
                                 torch.cuda.device_count(), "gpu")
    else:
        kind, count, platform = "cpu", 1, "cpu"
    print(json.dumps({"ok": True, "device": {"platform": platform,
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

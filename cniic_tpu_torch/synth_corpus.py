"""Deterministic synthetic corpus generator (zero-egress stand-in for DIV2K).

Copy of ``scripts/make_synth_corpus.py``, unchanged apart from its imports
and ``main(argv)``: the same generators, seeds and rng order, so the same
pixels; the PNGs are written by the port's stdlib ``image_io.save_png``
(the file bytes may differ from PIL's, the pixels do not). It touches no
device.

Usage:
  python -m cniic_tpu_torch.synth_corpus <out_dir> <n_images> [side]
  python -m cniic_tpu_torch.synth_corpus <out_dir> <n_images> --div2k
  python -m cniic_tpu_torch.synth_corpus <out_dir> <n_images> --textured
  python -m cniic_tpu_torch.synth_corpus <out_dir> <n_images> --midtex
  python -m cniic_tpu_torch.synth_corpus <out_dir> <n_images> --ns [side]
  python -m cniic_tpu_torch.synth_corpus <out_dir> --4k

The --div2k mode emits 2040x1356 images (the DIV2K_valid_HR typical shape,
SURVEY §6) with natural-image statistics: ~1/f^1.8 power spectra per
channel (the classic natural-image law), correlated chroma, a few
piecewise-flat regions, and mild sensor noise — the closest attainable
stand-in for the reference's chart corpus in a zero-egress container.

One rng (seed 7) is shared across the images of every mode but --ns and
--4k, so image i of a corpus can only be made by generating images 0..i in
order: ``mid_0001.png`` of ``--midtex`` is the second image of one run.
"""

import os
import sys

import numpy as np

from . import image_io


def synth(rng, h, w):
    yy = np.linspace(0, 4 * np.pi, h)[:, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :]
    base = 110 + 70 * np.sin(xx * 0.7 + rng.uniform(0, 6)) * np.cos(yy * 0.5) \
        + 45 * np.sin(0.23 * (xx * 3 + yy * 2) + rng.uniform(0, 6))
    img = np.stack([base, base * 0.8 + 30, 255 - base * 0.6], axis=-1)
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        hh, ww = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
        img[y0:y0 + hh, x0:x0 + ww] = rng.integers(0, 256, 3)
    img = img + rng.normal(0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def synth_natural(rng, h, w):
    """Natural-statistics field: 1/f^1.8 spectrum, correlated channels,
    flat patches, mild noise."""
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

    # piecewise-flat man-made regions (walls, sky patches): local mean fill
    for _ in range(int(rng.integers(4, 9))):
        y0, x0 = rng.integers(0, h * 3 // 4), rng.integers(0, w * 3 // 4)
        hh, ww = rng.integers(h // 12, h // 4), rng.integers(w // 12, w // 4)
        patch = img[y0:y0 + hh, x0:x0 + ww]
        img[y0:y0 + hh, x0:x0 + ww] = patch.mean(axis=(0, 1))

    img = img + rng.normal(0, 1.4, img.shape)  # mild sensor noise
    return np.clip(img, 0, 255).astype(np.uint8)


def synth_textured(rng, h, w, brightness=1.0):
    """Textured night-photo statistics (VERDICT r3 #4).

    DIV2K's lossy-chart magnitudes need two properties at once that the
    smooth `synth_natural` fields lack: (a) one *dominant* palette
    cluster — cluster-colors ratio 0.3-0.7% is 0.6-1.3 bits/px of id
    entropy, i.e. ~95% of pixels in one cluster that k-means does not
    subdivide — and (b) high-contrast detail at scales *below* the
    smallest voronoi cell (~36 px at k=2048), so within-cell color
    variance approaches photo levels (chart MSE 4,200-6,500) and stays
    roughly flat in k. Night photos have exactly this shape: dark
    sky/shadow mass plus fine bright structure everywhere.

    The dominant mass must hold real variance (cluster-colors chart MSE
    55-300) yet not fragment. The trick, borrowed from how 8-bit dark
    skies actually behave, is shadow *banding*: sigma~4 luminance grain
    quantized to a step-5 lattice along a single tint ray — ~50 MSE of
    variance carried by only ~30 unique colors, which therefore occupy
    one init chunk of the unique-color-weighted k-means at every k
    (clusterc.py's ascending-packed-key ordering) and survive Lloyd as a
    single cluster, exactly like a banded sky. Measured on this corpus
    (2040x1356): cluster-colors ratio 0.63-0.79% / MSE 52-62 across
    k=16..256; grid-cell variance (voronoi-MSE proxy) 4,500-7,200,
    ~flat in k."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = f[0, 1]
    spec = 1.0 / f ** 0.7  # clumpy-but-broad placement field

    ph = rng.normal(size=(h, w // 2 + 1)) + 1j * rng.normal(size=(h, w // 2 + 1))
    g = np.fft.irfft2(ph * spec, s=(h, w))

    # dominant dark background: a banded 1-D color family (8-bit shadow
    # banding): sigma~4 luminance grain quantized to step 5, then a fixed
    # per-channel tint — ~30 unique colors total, so the whole mass sits
    # inside ONE init chunk of the unique-color k-means at any k and
    # stays a single dominant palette cluster, while still carrying
    # ~50 MSE of real variance (what DIV2K's dark skies/shadows do)
    yy = np.linspace(0, 1, h)[:, None]
    base = 24 + 2 * yy + rng.normal(0, 4, (h, w))
    base = np.round(base / 5.0) * 5.0
    tint = np.array([0.85, 0.9, 1.15]) * rng.uniform(0.9, 1.1, 3)
    img = base[..., None] * tint[None, None, :]

    # `brightness` scales the bright-structure contrast against the dark
    # mass; within-cell variance goes as its square, so it is the direct
    # dial on the voronoi-MSE proxy (grid-cell variance). brightness=1 is
    # the r4 textured corpus (proxy 4,500-7,200); ~0.72 targets the proxy
    # band 2,600-4,000 whose 1.6x codec/proxy ratio puts the voronoi codec
    # inside the chart band 4,200-6,500 (VERDICT r4 #4).
    fam = brightness * np.array([[255, 190, 110], [170, 200, 255],
                                 [255, 240, 200]], dtype=np.float64)

    # broad fine-scale bright speckle: few-px grain of varied saturated
    # colors — the within-cell variance generator
    cover = rng.uniform(0.04, 0.06)
    mask = g > np.quantile(g, 1.0 - cover)
    nspk = int(mask.sum())
    colors = fam[rng.integers(0, len(fam), nspk)] + rng.normal(0, 10, (nspk, 3))
    img[mask] = colors * rng.uniform(0.75, 1.05, (nspk, 1))

    # oriented high-frequency gratings (signage / facades)
    for _ in range(int(rng.integers(6, 12))):
        hh, ww = int(rng.integers(h // 24, h // 8)), int(rng.integers(w // 24, w // 8))
        y0, x0 = int(rng.integers(0, h - hh)), int(rng.integers(0, w - ww))
        th = rng.uniform(0, np.pi)
        gy, gx = np.mgrid[0:hh, 0:ww]
        period = rng.uniform(3, 9)
        stripe = np.sin((np.cos(th) * gx + np.sin(th) * gy)
                        * (2 * np.pi / period)) > 0
        c = fam[rng.integers(0, len(fam))] * rng.uniform(0.7, 1.0)
        # basic-slice view: writes land in img directly (binary stripes:
        # no bg<->bright color smear)
        img[y0:y0 + hh, x0:x0 + ww][stripe] = c

    # small lit windows scattered frame-wide
    for _ in range(int(rng.integers(150, 300))):
        hh, ww = int(rng.integers(2, 14)), int(rng.integers(2, 14))
        y0, x0 = int(rng.integers(0, h - hh)), int(rng.integers(0, w - ww))
        img[y0:y0 + hh, x0:x0 + ww] = (
            fam[rng.integers(0, len(fam))] * rng.uniform(0.7, 1.0)
            + rng.normal(0, 5, 3))

    return np.clip(img, 0, 255).astype(np.uint8)


def synth_mixed(rng, i, h, w):
    """Corpus mix for the north-star measurement: 40% natural-statistics,
    30% legacy gradient+patch, 30% textured night-statistics — smooth and
    textured content in one corpus (VERDICT r4 #1)."""
    m = i % 10
    if m < 4:
        return synth_natural(rng, h, w)
    if m < 7:
        return synth(rng, h, w)
    return synth_textured(rng, h, w)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = [a for a in argv if not a.startswith("--")]
    out_dir = args[0] if args else "data/synth"
    n = int(args[1]) if len(args) > 1 else 24
    div2k = "--div2k" in argv
    os.makedirs(out_dir, exist_ok=True)
    if "--4k" in argv:
        # the golden-fixture image (tests/test_golden_4k.py pins its sha)
        img = synth_natural(np.random.default_rng(42), 2160, 3840)
        image_io.save_png(img, os.path.join(out_dir, "synth4k_0000.png"))
        print(f"wrote 3840x2160 image to {out_dir}")
        return
    rng = np.random.default_rng(7)
    if "--ns" in argv:
        # north-star corpus: n mixed-statistics images at BASELINE.md's
        # 1000-image scale (default side 1024; deterministic, resumable —
        # images are seeded per index so a partial run continues)
        side = int(args[2]) if len(args) > 2 else 1024
        for i in range(n):
            p = os.path.join(out_dir, f"ns_{i:05d}.png")
            if os.path.exists(p):
                continue
            img = synth_mixed(np.random.default_rng(1000 + i), i, side, side)
            image_io.save_png(img, p)
            if i % 100 == 0:
                print(f"{i}/{n}", flush=True)
        print(f"wrote {n} {side}x{side} mixed-statistics images to {out_dir}")
        return
    if "--textured" in argv:
        for i in range(n):
            image_io.save_png(synth_textured(rng, 1356, 2040),
                              os.path.join(out_dir, f"tex_{i:04d}.png"))
        print(f"wrote {n} 2040x1356 textured night-statistics images to {out_dir}")
        return
    if "--midtex" in argv:
        # proxy-tuned interpolation of the textured generator (VERDICT r4
        # #4): brightness 0.80 measures grid-cell variance ~3,000-3,300
        # (inside the 2,600-4,000 target band), which the measured ~1.6x
        # codec/proxy ratio maps into the reference chart's voronoi MSE
        # band 4,200-6,500
        for i in range(n):
            image_io.save_png(synth_textured(rng, 1356, 2040, brightness=0.80),
                              os.path.join(out_dir, f"mid_{i:04d}.png"))
        print(f"wrote {n} 2040x1356 proxy-tuned midtex images to {out_dir}")
        return
    if div2k:
        for i in range(n):
            image_io.save_png(synth_natural(rng, 1356, 2040),
                              os.path.join(out_dir, f"nat_{i:04d}.png"))
        print(f"wrote {n} 2040x1356 natural-statistics images to {out_dir}")
        return
    side = int(args[2]) if len(args) > 2 else 1024
    for i in range(n):
        image_io.save_png(synth(rng, side, side), os.path.join(out_dir, f"synth_{i:04d}.png"))
    print(f"wrote {n} {side}x{side} images to {out_dir}")


if __name__ == "__main__":
    sys.exit(main())

"""CLI entry point (reference src/main.rs), port of ``cniic_tpu/cli.py``.

    python -m cniic_tpu_torch --codec=<spec> [--device cuda|cpu]
                              [--batch=N] [--resume] <img files...>
    python -m cniic_tpu_torch --special=hilbert <img files...>

The device defaults to cuda; with no card the run is refused rather than
moved to the CPU (pass ``--device cpu`` for the plain CPU path).
``--special`` is tried first, then ``--codec`` (main.rs:17-21). The hilbert
special runs on the host: it dumps three CSVs per image (rect/small/large
traversals, main.rs:31-49) under ``output/``; the header is
``red,blue,green`` — the reference's exact (mislabeled) header — while the
values are r,g,b.

Under torchrun (WORLD_SIZE > 1 in the environment) each rank brings the
process group up through ``parallel.mesh.make_mesh`` on ``--device`` (NCCL
on cuda, one card a rank; gloo on the CPU), the k-means codecs shard their
lanes over it, and rank 0 alone writes the CSV, the decoded images and the
summary line:

    torchrun --nproc-per-node=4 -m cniic_tpu_torch --codec='voronoi(128)' \
        --batch=8 <img files...>
"""

from __future__ import annotations

import csv
import os
import sys

import torch.distributed as dist

from . import hilbert, image_io, runner
from .codecs import from_spec
from .parallel import mesh

USAGE = """Usage: python -m cniic_tpu_torch --codec=<codec> [--device cuda|cpu] [--batch=N] [--resume] [<img file>..]
       python -m cniic_tpu_torch --special=hilbert [<img file>..]
Available codecs:
  hufman
  zip(dict) | zip(back)
  hilbert(rle) | hilbert(rle(<d>)) | hilbert(zip)
  delta
  cluster-colors(<n>) | ccol(<n>)
  voronoi(<n>)"""


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _under_output(path: str, new_ext: str, output_dir: str = "output") -> str:
    base = os.path.basename(path)
    stem = os.path.splitext(base)[0]
    return os.path.join(output_dir, stem + "." + new_ext)


def _special_hilbert(paths) -> None:
    os.makedirs("output", exist_ok=True)
    for p in paths:
        img = image_io.load_image(p)
        h, w = img.shape[:2]

        def dump(coords, suffix):
            out = _under_output(p, f"{suffix}.hilbert.csv")
            with open(out, "w", newline="") as fh:
                cw = csv.writer(fh)
                cw.writerow(["red", "blue", "green"])  # reference header (main.rs:38)
                for x, y in coords:
                    px = img[y, x]
                    cw.writerow([px[0], px[1], px[2]])

        dump(hilbert.scan_coords(w, h), "rect")

        # "largest inscribed" power-of-two square, replicating the
        # reference's exact formula `next_power_of_two() >> 1`
        # (hilbert.rs:18) — including its quirk that an exactly
        # power-of-two dimension is HALVED (w=512 -> 256), since Rust's
        # next_power_of_two(512) == 512.
        so = min(_next_pow2(w) >> 1, _next_pow2(h) >> 1)
        # a dimension of 1 gives side 0: the reference's iterator is simply
        # empty there — emit a header-only CSV
        dump(hilbert.scan_coords(so, so) if so > 0 else [], "small")

        # smallest covering square, out-of-bounds filtered (hilbert.rs:25-32)
        so = max(_next_pow2(w), _next_pow2(h))
        coords = hilbert.scan_coords(so, so)
        dump(((x, y) for x, y in coords if x < w and y < h), "large")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    if argv[0].startswith("--special="):
        special = argv[0][len("--special="):]
        if special != "hilbert":
            print(f"Invalid special command: {special!r}", file=sys.stderr)
            return 1
        _special_hilbert(argv[1:])
        return 0

    batch = 1
    resume = False
    device = "cuda"
    rest = []
    args = iter(argv)
    for a in args:
        if a.startswith("--batch="):
            try:
                batch = int(a[len("--batch="):])
            except ValueError:
                print(f"Malformed batch argument: {a!r}", file=sys.stderr)
                print(USAGE, file=sys.stderr)
                return 1
        elif a == "--resume":
            resume = True
        elif a == "--device":
            device = next(args, "")
        elif a.startswith("--device="):
            device = a[len("--device="):]
        else:
            rest.append(a)
    if device not in ("cuda", "cpu"):
        print(f"Malformed device argument: {device!r} (cuda or cpu)",
              file=sys.stderr)
        return 1
    if not rest or not rest[0].startswith("--codec="):
        print(USAGE, file=sys.stderr)
        return 1
    command, files = rest[0], rest[1:]
    try:
        codec = from_spec(command[len("--codec="):], device=device)
    except RuntimeError as e:  # the device is missing
        print(f"Device unavailable\n{e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"Malformed codec argument\n{e}", file=sys.stderr)
        return 1
    ranks = int(os.environ.get("WORLD_SIZE", "1") or "1")
    if ranks > 1:
        mesh.make_mesh(ranks, device=device)
    try:
        res = runner.measure_all(codec, files, batch=batch, resume=resume)
    finally:
        if ranks > 1:
            dist.destroy_process_group()
    if ranks <= 1 or os.environ.get("RANK", "0") == "0":
        print(f"{codec.name}: {len(res.rows)} images ok, "
              f"{len(res.failures)} failed; mean ratio {res.mean_ratio:.3f}%, "
              f"mean MSE {res.mean_error:.3f}; encode {res.encode_mps:.3f} "
              f"MP/s on {codec.device}")
    return 0 if not res.failures else 2

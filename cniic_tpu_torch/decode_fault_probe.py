"""Where a codec's decode time goes after its encode in one process: the
seconds, the process's CPU seconds and minor page faults of each step.

    python -m cniic_tpu_torch.decode_fault_probe [--device=cuda]
        [--spec=cluster-colors(32)] [--seed=7] [--images=8] [--passes=8]
        [--height=1356] [--width=2040]

The images are `synth_corpus --midtex`'s first `--images` (2040x1356 at
`--seed`, as the benchmark's midtex cells make them). One untimed pass,
then `--passes` closed-loop passes as the benchmark's cells run them:
`encode_batch`, then `decode_batch` and `runner.compute_error` on every
image. Then `--passes` decode-only passes over the last pass's streams,
with no encode between them; then, where the build has it, the same
after releasing the CUDA caching allocators' cached device and pinned host
blocks. For each step, the seconds (`time.perf_counter`, the device
synchronized), the CPU seconds of all the process's threads and the minor
page faults it took (`getrusage`), the process's thread count, and after
each encode glibc's heap arena and mmapped bytes (`mallinfo2`, where the C
library has it). A decode that runs slower after an encode than alone, with
more faults, pays for memory the allocator handed back to the kernel in
between; CPU seconds above the wall seconds are threads at work beside
the calling one (the host-C codecs' `decode_batch` spreads its images over
the host's allowed CPUs, `codecs.base.host_map`; cluster-colors' decodes
one image after another on the calling thread).

The last line is one JSON object: the card, the medians of each step's
readings in each phase, and every pass's readings. Exit 1 if a decoded
image's MSE differs between the phases.
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import json
import os
import resource
import statistics
import sys
import time

import numpy as np
import torch

from . import synth_corpus
from .bench import device_label
from .codecs import from_spec
from .experiments import open_device, sync
from .runner import compute_error


class _MallInfo2(ctypes.Structure):
    _fields_ = [(f, ctypes.c_size_t) for f in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def _mallinfo():
    """glibc's heap arena and mmapped bytes, or None without mallinfo2."""
    libc = ctypes.CDLL(ctypes.util.find_library("c") or None)
    fn = getattr(libc, "mallinfo2", None)
    if fn is None:
        return None
    fn.restype = _MallInfo2
    m = fn()
    return {"arena": m.arena, "mmapped": m.hblkhd, "free": m.fordblks}


def _usage():
    """(CPU seconds of every thread, minor page faults) so far."""
    u = resource.getrusage(resource.RUSAGE_SELF)
    return u.ru_utime + u.ru_stime, u.ru_minflt


def _threads() -> int:
    try:
        return len(os.listdir("/proc/self/task"))
    except OSError:
        return 0


def _step(dev, fn, prefix: str) -> tuple:
    """(result, readings) of `fn()`, the device synchronized: its seconds,
    CPU seconds, minor faults and the thread count before it."""
    sync(dev)
    threads = _threads()
    (c0, f0), t0 = _usage(), time.perf_counter()
    out = fn()
    sync(dev)
    t1, (c1, f1) = time.perf_counter(), _usage()
    return out, {f"{prefix}_s": t1 - t0, f"{prefix}_cpu_s": c1 - c0,
                 f"{prefix}_faults": f1 - f0, f"{prefix}_threads": threads}


def _release_cached(dev) -> bool:
    """Hand the CUDA caching allocators' cached blocks back (device, and
    pinned host where the build has the call); False where it cannot."""
    host = getattr(torch._C, "_host_emptyCache", None)
    if dev.type != "cuda" or host is None:
        return False
    torch.cuda.empty_cache()
    host()
    return True


def _decode(codec, blobs, imgs):
    return [compute_error(a, b)
            for a, b in zip(imgs, codec.decode_batch(blobs))]


def probe(imgs, spec: str, passes: int, dev) -> dict:
    codec = from_spec(spec, device=dev.type)
    blobs = codec.encode_batch(imgs)                    # warmup
    _decode(codec, blobs, imgs)
    after_encode, alone, released = [], [], []
    for _ in range(passes):
        blobs, enc = _step(dev, lambda: codec.encode_batch(imgs), "encode")
        heap = _mallinfo()
        mses, dec = _step(dev, lambda: _decode(codec, blobs, imgs), "decode")
        after_encode.append({**enc, "heap": heap, **dec})
    same = True
    for rows in (alone, released):
        if rows is released and not _release_cached(dev):
            break
        for _ in range(passes):
            again, dec = _step(dev, lambda: _decode(codec, blobs, imgs),
                               "decode")
            same &= again == mses
            rows.append(dec)
    def med(rows, key):
        return statistics.median(r[key] for r in rows) if rows else None

    mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
    out = {"spec": spec, "megapixels": mp, "same_mses": same}
    for name, rows in (("decode_after_encode", after_encode),
                       ("decode_alone", alone),
                       ("decode_released", released)):
        for key in ("s", "cpu_s", "faults", "threads"):
            out[f"{name}_{key}"] = med(rows, f"decode_{key}")
    for key in ("s", "cpu_s", "faults"):
        out[f"encode_{key}"] = med(after_encode, f"encode_{key}")
    out.update(after_encode=after_encode, alone=alone, released=released)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spec", default="cluster-colors(32)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--passes", type=int, default=8)
    ap.add_argument("--height", type=int, default=1356)
    ap.add_argument("--width", type=int, default=2040)
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    if dev is None:
        return 1
    rng = np.random.default_rng(args.seed)
    imgs = [synth_corpus.synth_textured(rng, args.height, args.width,
                                        brightness=0.80)
            for _ in range(args.images)]
    r = probe(imgs, args.spec, args.passes, dev)
    r["device"] = device_label(dev.type)
    for name in ("decode_after_encode", "decode_alone", "decode_released",
                 "encode"):
        if r[f"{name}_s"] is not None:
            print(f"{args.spec} on {r['device']}: {name} {r[f'{name}_s']:.4f}"
                  f" s, CPU {r[f'{name}_cpu_s']:.4f} s, "
                  f"{r[f'{name}_faults']} faults, "
                  f"{r.get(f'{name}_threads', '-')} threads", flush=True)
    print(json.dumps(r))
    return 0 if r["same_mses"] else 1


if __name__ == "__main__":
    sys.exit(main())

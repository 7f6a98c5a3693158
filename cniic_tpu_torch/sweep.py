"""Sweep driver with device/host overlap: the Makefile's 22-config matrix.

Copy of ``scripts/run_sweep.py``, unchanged apart from its imports,
``main(argv)`` and ``--device``. The Makefile matrix runs its 22 configs
strictly serially; during the k-means configs (cluster-colors, voronoi)
the host thread mostly waits on the card, and during the host-C configs
(zip, hufman, hilbert) the card sits idle. This driver is the sweep-scope
analog of the reference's rayon fan-out (bench.rs:22-27): two queues on two
threads —

  device queue: cluster-colors(16..256), voronoi(64..2048)
  host queue:   hufman, delta, hilbert-*, zip-*, approx(1..16)

The host-C engines release the GIL inside ctypes calls and the device queue
releases it while it waits on the card, so the host queue runs inside the
device queue's wait windows; within a host config, the codec's
`encode_batch`/`decode_batch` spread each batch's images over the host's
allowed CPUs (`codecs.base.host_map`). Each config still runs through the stock
`runner.measure_all` and writes its own CSV — streams and CSV contents are
byte-identical to serial runs by construction (the queues share no codec
state, and the card is touched only by the device queue). The sweep brings
no process group up, so the runner keeps its encode thread.

Usage:
  python -m cniic_tpu_torch.sweep [--device=cuda|cpu] [--batch=4] [--serial]
                                  [--out=output] [--configs=a,b,...] <pngs...>

The device defaults to cuda; with no card the sweep is refused, never moved
to the CPU. --serial runs the same set on one thread (the A/B baseline).
Prints per-queue and total wall-clock.
"""

from __future__ import annotations

import csv
import glob as globlib
import os
import sys
import threading
import time

from . import resolve_device, runner
from .codecs import from_spec

DEVICE_CONFIGS = [
    "cluster-colors(16)", "cluster-colors(32)", "cluster-colors(64)",
    "cluster-colors(128)", "cluster-colors(256)",
    "voronoi(64)", "voronoi(128)", "voronoi(256)", "voronoi(512)",
    "voronoi(1024)", "voronoi(2048)",
]
HOST_CONFIGS = [
    "hufman", "delta", "hilbert(rle)", "hilbert(zip)",
    "zip(dict)", "zip(back)",
    "hilbert(rle(1))", "hilbert(rle(2))", "hilbert(rle(4))",
    "hilbert(rle(8))", "hilbert(rle(16))",
]


def split_configs(configs=None):
    """Route configs to the (device, host) queues: the k-means codecs own
    the device; everything else is host-C. The single routing authority —
    tests assert on this function, not a copy."""
    if configs is None:
        return DEVICE_CONFIGS, HOST_CONFIGS
    dev = [c for c in configs
           if c.startswith(("cluster-colors", "voronoi", "ccol", "c-col"))]
    return dev, [c for c in configs if c not in dev]


COLUMNS = ("compressed_size", "compression_ratio", "error")


def read_rows(path) -> dict:
    """A runner CSV's rows: image basename -> its last three columns, as
    the CSV writes them."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))[1:]
    return {os.path.basename(r[0]): tuple(r[1:4]) for r in rows if r}


def diff_rows(got_dir, want_dir, names, images=None) -> list:
    """Where the CSVs `<name>.csv` of `got_dir` differ from `want_dir`'s:
    one line for each missing CSV or row and each differing column, rows
    matched by image basename (`images`, or every row of `want_dir`'s)."""
    out = []
    for name in names:
        want = read_rows(os.path.join(want_dir, f"{name}.csv"))
        path = os.path.join(got_dir, f"{name}.csv")
        if not os.path.exists(path):
            out.append(f"{name}: no CSV in {got_dir}")
            continue
        got = read_rows(path)
        for img in sorted(want) if images is None else images:
            if img not in want or img not in got:
                where = want_dir if img not in want else got_dir
                out.append(f"{name} {img}: no row in {where}")
                continue
            out.extend(f"{name} {img}: {col} {a} != {b} (reference)"
                       for col, a, b in zip(COLUMNS, got[img], want[img])
                       if a != b)
    return out


def run_queue(name, specs, paths, out_dir, batch, results, errors,
              device="cuda", seconds=None):
    """Run `specs` one after the other; `results[name]` gets the queue's
    wall time and, when given, `seconds[spec]` each config's."""
    t0 = time.perf_counter()
    for spec in specs:
        t1 = time.perf_counter()
        try:
            res = runner.measure_all(from_spec(spec, device=device), paths,
                                     output_dir=out_dir,
                                     verbose=False, batch=batch)
        except Exception as e:  # a dead queue must fail the sweep, not
            errors.append(f"{name}/{spec}: {e!r}")  # silently return 0
            print(f"[{name}] {spec}: FAILED {e!r}", flush=True)
            continue
        ok = len(res.rows)
        fail = len(res.failures)
        if fail:
            errors.append(f"{name}/{spec}: {fail} image(s) failed")
        took = time.perf_counter() - t1
        if seconds is not None:
            seconds[spec] = took
        print(f"[{name}] {spec}: {ok} ok/{fail} failed {took:.1f}s",
              flush=True)
    results[name] = time.perf_counter() - t0


def main(argv=None, results=None, seconds=None):
    """Run the sweep; `results` and `seconds`, when given, receive the
    queues' and the configs' wall times."""
    argv = list(sys.argv[1:] if argv is None else argv)
    batch, serial, out_dir, device = 4, False, "output", "cuda"
    configs = None
    paths = []
    for a in argv:
        if a.startswith("--batch="):
            batch = int(a[len("--batch="):])
        elif a == "--serial":
            serial = True
        elif a.startswith("--out="):
            out_dir = a[len("--out="):]
        elif a.startswith("--configs="):
            configs = a[len("--configs="):].split(",")
        elif a.startswith("--device="):
            device = a[len("--device="):]
        else:
            # expand globs ourselves so a quoted 'data/x/*.png' (or a
            # caller that skips the shell) works the same as unquoted
            paths.extend(sorted(globlib.glob(a)) or [a])
    if not paths:
        print(__doc__, file=sys.stderr)
        return 1
    try:
        resolve_device(device)
    except (RuntimeError, ValueError) as e:  # no card: refused, not the CPU
        print(f"Device unavailable\n{e}", file=sys.stderr)
        return 1

    dev, host = split_configs(configs)

    results = {} if results is None else results
    errors: list = []
    t0 = time.perf_counter()
    if serial:
        run_queue("serial", dev + host, paths, out_dir, batch, results, errors,
                  device, seconds)
    else:
        # the overlap rationale requires the host queue to stay off the
        # device; the opt-in device entropy paths would break that (and
        # the per-queue timings) if left exported
        for flag in ("CNIIC_DEVICE_BITPACK", "CNIIC_DEVICE_HUF_DECODE"):
            if os.environ.pop(flag, None) is not None:
                print(f"note: {flag} disabled for the overlapped sweep",
                      flush=True)
        th = threading.Thread(
            target=run_queue,
            args=("host", host, paths, out_dir, batch, results, errors,
                  device, seconds))
        th.start()
        try:
            run_queue("device", dev, paths, out_dir, batch, results, errors,
                      device, seconds)
        finally:
            th.join()
    total = time.perf_counter() - t0
    for k, v in results.items():
        print(f"{k} queue: {v:.1f}s")
    print(f"total wall-clock: {total:.1f}s "
          f"({'serial' if serial else 'overlapped'})")
    if errors:
        print(f"{len(errors)} failure(s):")
        for e in errors:
            print(f"  {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

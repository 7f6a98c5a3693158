"""The benchmark's cells, read from `BENCHMARK.json`, and how each is run,
checked and measured.

A cell (an entry of `BENCHMARK.json`'s `workloads`) names its corpus, seed,
batch, timed passes, routes and pins; a route is a codec spec and,
optionally, a gate group of the cell's configuration file
(`benchmark/configs/`), which gives the env gates the route runs with, the
device kernels they send it to and whether its streams must equal the
ungated ones. A cell drives the port through its public entry points
(`codecs.from_spec(...).encode_batch`, `decode_batch` or the fused
`decode_mse_batch`, the runner's `compute_error`) as a closed loop: one
batch at a time, each pass encoding the batch, then decoding and verifying
it. A warmup pass (library builds, first launches) comes first, then the
cell's timed passes, then one traced pass that gives the per-layer
metrics, so the end-to-end metrics are taken with tracing off.

End-to-end metrics, each per cell:

* `encode_mps` (MP/s): the geometric mean over the cell's routes of each
  route's throughput over all its timed passes, the megapixels of the
  passes over the sum of their encode seconds;
* `decode_mps` (MP/s): the same over decode and verify (voronoi's decode is
  the fused decode + exact MSE on the card);
* `failed_share`: images that failed over images attempted, in every pass.

A pass that fails an image (its encode or decode raises, or a batched
encode returns an exception in an image's place) counts no megapixels but
its seconds, and the cell's `correct` is false. The per-pass rates'
quartiles are reported beside each metric as its spread.

`correct` holds the outputs to the program's own standards. At any seed:
each lossless codec decodes to MSE 0, each lossy codec's reported MSE equals
an MSE recomputed here from its decoded image, every timed pass gives the
streams of the first, and each gated stream equals the ungated stream of the
same image in the same run where its gate group says it must. At the default
seed and size, also the workload's `pins`: runner rows by image name
(`rows`, a directory of CSVs), the first image's (ratio, MSE) as the bench
prints them (`full_size`) and the streams' SHA-256 (`sha256`).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import hashlib
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from cniic_tpu_torch import (bench, hilbert, native, resolve_device, sweep,
                             synth_corpus, trace)
from cniic_tpu_torch.codecs import from_spec
from cniic_tpu_torch.experiments.profile_clusterc import profile_group
from cniic_tpu_torch.kmeans_profile import IterLog
from cniic_tpu_torch.ops import approx_rle, bitpack, hufdec, kmeans_kernel
from cniic_tpu_torch.ops import kmeans as km
from cniic_tpu_torch.runner import compute_error

from . import roofline
from .window import device_window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")

MIDTEX_SHAPE = (1356, 2040)    # synth_corpus --midtex: DIV2K's frame shape
MIDTEX_BRIGHTNESS = 0.80       # synth_corpus --midtex
SUITE_SIDE = 1024              # bench.SUITE's images
PINNED_IMAGES = 8              # the images a pin file holds per codec

UNITS = {"encode_mps": "MP/s", "decode_mps": "MP/s",
         "failed_share": "failed images / attempted images"}


@dataclasses.dataclass(frozen=True)
class Route:
    """One codec spec under the env gates of its gate group."""
    spec: str
    env: tuple = ()             # (name, value) pairs, set for the route
    kernels: tuple = ()         # the device kernels the gates send it to
    own_streams: bool = False   # its streams may differ from the ungated

    @property
    def label(self) -> str:
        names = [k for k, _ in self.env]
        return self.spec + (f" [{'+'.join(names)}]" if names else "")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    corpus: str        # "midtex" or "suite"
    seed: int          # the default workload seed, the pins' seed
    images: int        # a batch, and the images of a cell
    passes: int        # timed passes
    routes: tuple
    pins: tuple = ()   # (kind, path from the checkout's root) pairs


def read_json(path: str):
    with open(os.path.join(ROOT, path)) as fh:
        return json.load(fh)


def load_cells(path: str = BENCHMARK) -> tuple:
    """(cell name -> Cell, every env gate any configuration names), from
    `BENCHMARK.json` and the configuration files it names."""
    spec = read_json(path)
    configs = {n: read_json(p) for n, p in spec["configs"].items()}
    gates = sorted({g for c in configs.values()
                    for group in c["gates"].values() for g in group["env"]})
    cells = {}
    for w in spec["workloads"]:
        groups = configs[w["config"]]["gates"]
        routes = []
        for r in w["routes"]:
            g = groups[r["gates"]] if "gates" in r else {}
            routes.append(Route(r["spec"], tuple(g.get("env", {}).items()),
                                tuple(g.get("kernels", ())),
                                not g.get("streams_equal_ungated", True)))
        cells[w["name"]] = Cell(w["name"], w["config"], w["corpus"],
                                w["seed"], w["images"], w["passes"],
                                tuple(routes), tuple(w["pins"].items()))
    return cells, tuple(gates)


CELLS, GATES = load_cells()


# --------------------------------------------------------------------------
# the corpora: the program receives only these images
# --------------------------------------------------------------------------

def midtex_images(seed: int, count: int) -> dict:
    """`synth_corpus --midtex`'s first `count` images, by name."""
    rng = np.random.default_rng(seed)
    return {f"mid_{i:04d}.png": synth_corpus.synth_textured(
        rng, *MIDTEX_SHAPE, brightness=MIDTEX_BRIGHTNESS)
        for i in range(count)}


def suite_images(seed: int, count: int) -> dict:
    """spec -> its `count` images, drawn afresh per codec in `bench.SUITE`'s
    order, as `bench.py` draws them."""
    rng = np.random.default_rng(seed)
    return {spec: [bench.synth_image(rng, SUITE_SIDE, SUITE_SIDE)
                   for _ in range(count)] for spec, _, _ in bench.SUITE}


def cell_images(cell: Cell, seed: int):
    """(route label -> images, image names)."""
    if cell.corpus == "midtex":
        named = midtex_images(seed, cell.images)
        return {r.label: list(named.values()) for r in cell.routes}, \
            list(named)
    # a route whose spec is not the suite's (another k) takes the images
    # of the suite entry at its own index
    suite = suite_images(seed, cell.images)
    order = list(suite.values())
    return ({r.label: suite.get(r.spec, order[i])
             for i, r in enumerate(cell.routes)},
            [f"img_{i}" for i in range(cell.images)])


@contextlib.contextmanager
def gates_on(env):
    """The env gates: those of `env` ((name, value) pairs) set, the rest of
    `GATES` unset, for the duration; then what was there before."""
    old = {g: os.environ.get(g) for g in GATES}
    for g in GATES:
        os.environ.pop(g, None)
    os.environ.update(dict(env))
    try:
        yield
    finally:
        for g, val in old.items():
            if val is None:
                os.environ.pop(g, None)
            else:
                os.environ[g] = val


# --------------------------------------------------------------------------
# one pass of a route
# --------------------------------------------------------------------------

def host_mse(a: np.ndarray, b: np.ndarray) -> float:
    """bench.rs's MSE recomputed in numpy: the integer sum of squared
    channel differences over the pixel count."""
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum()) / (a.shape[0] * a.shape[1])


@dataclasses.dataclass
class Pass:
    """One encode and decode of a batch. `blobs` holds each image's stream,
    or the exception in a failed image's place; `mses` and `decoded` hold
    None for a failed image."""
    encode_s: float = math.nan
    decode_s: float = math.nan
    blobs: list = None
    mses: list = None
    decoded: list = None
    failed: int = 0


def run_pass(codec, imgs) -> Pass:
    """Encode the batch, then decode and verify it (`finish_pass`)."""
    p = Pass()
    t0 = time.perf_counter()
    try:
        p.blobs = codec.encode_batch(imgs)
    except Exception as e:  # a failing codec is a measured outcome
        p.blobs = [e] * len(imgs)
    p.encode_s = time.perf_counter() - t0
    return finish_pass(p, codec, imgs)


def finish_pass(p: Pass, codec, imgs, decode=None) -> Pass:
    """Decode and verify the pass's streams: the fused decode + MSE where
    the codec has one, else `decode_batch` and the runner's
    `compute_error`; `decode` replaces that step (a profiler window)."""
    ok = [i for i, b in enumerate(p.blobs) if not isinstance(b, Exception)]
    p.mses, p.decoded = [None] * len(imgs), [None] * len(imgs)
    t0 = time.perf_counter()
    try:
        mses, fetch = (decode or decode_verify)(
            codec, [p.blobs[i] for i in ok], [imgs[i] for i in ok])
        p.decode_s = time.perf_counter() - t0
        for j, i in enumerate(ok):
            p.mses[i] = mses[j]
        for j, im in enumerate(fetch()):
            p.decoded[ok[j]] = im
    except Exception as e:  # a failing decode is a measured outcome
        if math.isnan(p.decode_s):   # its seconds count all the same
            p.decode_s = time.perf_counter() - t0
        p.blobs = [e if i in ok else b for i, b in enumerate(p.blobs)]
        p.mses = [None] * len(imgs)
        ok = []
    p.failed = len(imgs) - len(ok)
    return p


def decode_verify(codec, blobs, imgs):
    """(reported MSEs, fetch of the decoded images): the timed decode."""
    fused = getattr(codec, "decode_mse_batch", None)
    if not blobs:
        return [], list
    if fused is not None:
        return fused(blobs, imgs)
    decs = codec.decode_batch(blobs)
    return [compute_error(a, b) for a, b in zip(imgs, decs)], lambda: decs


def digest(blob) -> str:
    return hashlib.sha256(blob).hexdigest()


def pass_problems(label, codec, imgs, p: Pass, first: Pass | None) -> list:
    """What a pass got wrong: lossless MSEs, reported against recomputed
    MSEs, and streams that differ from the first timed pass's."""
    out = []
    for i, (im, mse, dec) in enumerate(zip(imgs, p.mses, p.decoded)):
        if mse is None:
            out.append(f"{label} image {i}: failed ({p.blobs[i]!r:.200})")
            continue
        if codec.is_lossless and mse != 0.0:
            out.append(f"{label} image {i}: lossless codec with MSE {mse}")
        want = host_mse(im, dec)
        if mse != want:
            out.append(f"{label} image {i}: reported MSE {mse!r} != "
                       f"{want!r} recomputed from the decoded image")
        if (first is not None and first.mses[i] is not None
                and p.blobs[i] != first.blobs[i]):
            out.append(f"{label} image {i}: the stream differs from the "
                       "first timed pass's")
    return out


# --------------------------------------------------------------------------
# the pins, at the default seed and size
# --------------------------------------------------------------------------

def csv_row(blob: bytes, img, mse) -> tuple:
    """(compressed_size, compression_ratio, error) as the runner's CSV
    writes them."""
    h, w = img.shape[:2]
    return str(len(blob)), str(len(blob) / (w * h * 24) * 100.0), str(mse)


def rows_problems(rows: dict, images, pins_dir: str) -> list:
    """`rows`: codec name -> image name -> its CSV row (`csv_row`), held
    against `<pins_dir>/<name>.csv` by `sweep.diff_rows`."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, by_image in rows.items():
            with open(os.path.join(tmp, f"{name}.csv"), "w",
                      newline="") as fh:
                w = csv.writer(fh)
                w.writerow(["name", *sweep.COLUMNS])
                w.writerows([img, *row] for img, row in by_image.items())
        return sweep.diff_rows(tmp, os.path.join(ROOT, pins_dir), list(rows),
                               images)


def full_size_cell(blob: bytes, img, mse) -> list:
    """(ratio %, MSE) of a suite cell's first image as `bench.py` prints
    them."""
    h, w = img.shape[:2]
    return [f"{len(blob) / (w * h * 24) * 100:.3f}", f"{mse:.1f}"]


def full_size_problems(seen: dict, path: str) -> list:
    want = read_json(path)["cells"]
    return [f"{name}: (ratio, MSE) {seen.get(name)} != pinned {w}"
            for name, w in want.items() if seen.get(name) != w]


def hash_problems(seen: dict, path: str) -> list:
    """`seen`: route label -> the SHA-256 of its streams, in image order."""
    want = read_json(path)["streams"]
    out = []
    for label, got in seen.items():
        if label not in want:
            out.append(f"{label}: no pin")
            continue
        out += [f"{label} image {i}: stream {g[:16]} != pinned {w[:16]}"
                for i, (g, w) in enumerate(zip(got, want[label])) if g != w]
    return out


def k3_walker_problems(label, codec, imgs, dev) -> list:
    """K3's chunk schedule against one walker a stream (`chunk` >= L) on
    the route's scans, batched as the codec batches them: the records
    must be equal. K3 is the f32 form of the recurrence, so its streams
    are held to this and to their pins (cniic_tpu's K3), not to the exact
    engine's."""
    scans = [hilbert.linearize(im) for im in imgs]
    lens = [s.shape[0] for s in scans]
    batch = np.zeros((len(scans), max(lens), 3), np.uint8)
    for i, s in enumerate(scans):
        batch[i, :lens[i]] = s
    rgb, n = approx_rle._position_major(batch, lens, dev)
    chunks = approx_rle.batch_records(rgb, n, codec.allow)
    walker = approx_rle.batch_records(rgb, n, codec.allow,
                                      chunk=rgb.shape[0])
    if torch.equal(chunks, walker):
        return []
    return [f"{label}: K3's chunk schedule differs from one walker a stream"]


def pins_apply(cell: Cell, seed: int) -> bool:
    """The pins hold the default seed's images at the published sizes."""
    published = (MIDTEX_SHAPE == (1356, 2040) if cell.corpus == "midtex"
                 else SUITE_SIDE == 1024)
    return seed == cell.seed and cell.images == PINNED_IMAGES and published


# --------------------------------------------------------------------------
# the traced pass: per-layer metrics
# --------------------------------------------------------------------------

_WALK = ("speculate_kernel", "repair_kernel", "settle_kernel")
KERNELS = {   # the kernels of each wrapper, named as the profiler shows them
    "K1": ("assign_stats_kernel",),   # K1 with D3 in each lane's last block
    "K3": _WALK,
    "K2": _WALK + ("wide_flags_kernel",),
    "D1": ("book_kernel", "pack_tiles_kernel"),  # a book only past 1024 codes
    "D2": ("table_kernel", "walk_kernel"),
}
COUNTED = {   # the kernels a window must show: kernel -> its launch counter
    "K1": {"assign_stats_kernel": "K1"},
    "K3": dict.fromkeys(_WALK, "K3"),
    "K2": dict.fromkeys(KERNELS["K2"], "K2"),
    "D1": {"pack_tiles_kernel": "D1"},
    "D2": {"table_kernel": "D2 tables", "walk_kernel": "D2"},
}


DECODE_KERNELS = ("D2",)   # the kernels a route's decode launches


def counters() -> dict:
    """The launch counters of the kernels' wrappers (calls that launched),
    and the points K1's pruned instance scanned (a device read)."""
    return {"K1": kmeans_kernel.assign_stats.launches,
            "K1 scanned": kmeans_kernel.scanned_points(),
            "K3": approx_rle.batch_records.launches,
            "K3 kernels": approx_rle.batch_records.kernel_launches,
            "K2": approx_rle.wide_records.launches,
            "K2 kernels": approx_rle.wide_records.kernel_launches,
            "D1": bitpack.pack_words.launches,
            "D2": hufdec.walk.launches,
            "D2 tables": hufdec.root_table.launches}


def expected(kind: str, launches: dict) -> dict:
    """Kernel name -> launches a window must show for the `kind` route's
    calls counted in `launches` (the counters' differences over the call)."""
    return {key: launches[c] for key, c in COUNTED[kind].items()}


def encode_kernels(route: Route, codec) -> tuple:
    """The device routes a route's encode launches."""
    if codec.name.startswith(("cluster-colors", "voronoi")):
        return ("K1",)
    return tuple(k for k in route.kernels if k not in DECODE_KERNELS)


@contextlib.contextmanager
def lane_counts():
    """Each k-means loop the engine drives meanwhile, as (the lanes' point
    counts, the lanes' iteration counts, d, k, whether K1's pruned instance
    runs it), tensors read once the loops are done: the engine keeps a
    lane's count on the device, one added for every launch the lane is
    active in."""
    loops = []
    step = km.prepare_step

    def probe(ptsT, w, cur, cents, n, act, pmax, sums, moved_k, moved, best,
              stall, it, *rest, **kw):
        fn = step(ptsT, w, cur, cents, n, act, pmax, sums, moved_k, moved,
                  best, stall, it, *rest, **kw)
        loops.append((n, it, ptsT.shape[1], cents.shape[1], fn.pruned))
        return fn

    km.prepare_step = probe
    try:
        yield loops
    finally:
        km.prepare_step = step


@contextlib.contextmanager
def k2_route_split(spent: dict):
    """Host seconds of the K2 route's parts, added into `spent`: the K2
    calls (`approx_rle_wide`, its record extraction included), the record
    extraction (`_runs`) and the stitcher's native replays."""
    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        return wrapper

    saved = (approx_rle.approx_rle_wide, approx_rle._runs,
             native.approx_rle_encode)
    approx_rle.approx_rle_wide = timed("wide", saved[0])
    approx_rle._runs = timed("runs", saved[1])
    native.approx_rle_encode = timed("native", saved[2])
    try:
        yield spent
    finally:
        (approx_rle.approx_rle_wide, approx_rle._runs,
         native.approx_rle_encode) = saved


def k1_layer(win, launches: int, loops, iters: int,
             scanned: int = 0) -> dict:
    """K1's readings: launches, the loops' iterations, and from a window
    its mean span, its mean bound over the same launches (each bounded on
    the lanes active in it) and their ratio; over the loops K1's pruned
    instance ran, the points it scanned over the points of their active
    lanes (None when it ran none)."""
    bound, by = 0.0, {}
    for n, it, d, k, _ in loops:
        ms, _, what = roofline.loop_bound_ms(n.tolist(), it.tolist(), d, k)
        bound += ms
        for key, v in what.items():
            by[key] = by.get(key, 0) + v
    pruned_points = sum(sum(a * b for a, b in zip(n.tolist(), it.tolist()))
                        for n, it, _, _, pruned in loops if pruned)
    out = {"k1_launches": launches, "kmeans_iters": iters,
           "k1_bound_by": by, "k1_ms": None, "k1_bound_ms": None,
           "k1_roofline_share": None,
           "k1_scanned_share": (scanned / pruned_points if pruned_points
                                else None)}
    if win is not None and launches:
        spans = win["spans"]["assign_stats_kernel"]
        out["k1_ms"] = sum(spans) / len(spans) / 1e3
        out["k1_bound_ms"] = bound / launches
        out["k1_roofline_share"] = out["k1_bound_ms"] / out["k1_ms"]
    return out


CALL_KERNEL = {"K3": "settle_kernel", "K2": "wide_flags_kernel",
               "D1": "pack_tiles_kernel", "D2": "table_kernel"}


def kernel_ms(win, kind: str, calls: int):
    """Device ms a wrapper call of the `kind` route's kernels, summed over
    the calls the window saw (one `CALL_KERNEL` each)."""
    if win is None or not calls:
        return None
    seen = len(win["spans"][CALL_KERNEL[kind]])
    return sum(sum(win["spans"][key]) for key in KERNELS[kind]) / seen / 1e3


def seen_short(win) -> dict:
    """The window's shortfall, kernel -> [seen, launched], if any."""
    return {} if win is None else {k: list(v)
                                   for k, v in win["short"].items()}


def windowed(fn, kinds, on_card: bool):
    """(result, window, launches) of `fn()`: under a device window on the
    card that must show every kernel of `kinds` its wrappers counted; the
    counters' differences over the (last) call."""
    state = {}

    def call():
        before = counters()
        result = fn()
        after = counters()
        state["launches"] = {k: after[k] - before[k] for k in after}
        return result, {key: n for kind in kinds
                        for key, n in expected(kind, state["launches"])
                        .items()}

    if not on_card:
        return call()[0], None, state["launches"]
    keys = [key for kind in kinds for key in KERNELS[kind]]
    result, win = device_window(call, keys)
    return result, win, state["launches"]


def traced_pass(route: Route, codec, imgs, dev) -> tuple:
    """(Pass, per-layer readings) of one pass under the tracers: a device
    window around the encode (and around the decode for D2), the engine's
    lane counts, `trace`'s Huffman spans and the K2 route's host split."""
    on_card = dev.type == "cuda"
    kinds = encode_kernels(route, codec)
    p = Pass()
    st = {}

    def encode():
        trace.reset()
        st["spent"] = {}
        with contextlib.ExitStack() as stack:
            st["loops"] = stack.enter_context(lane_counts())
            log = stack.enter_context(IterLog())
            if "K2" in kinds:
                stack.enter_context(k2_route_split(st["spent"]))
            t0 = time.perf_counter()
            try:
                blobs = codec.encode_batch(imgs)
            except Exception as e:  # a failing codec is a measured outcome
                blobs = [e] * len(imgs)
            p.encode_s = time.perf_counter() - t0
        st["iters"] = log.iters
        return blobs

    p.blobs, enc_win, launches = windowed(encode, kinds, on_card)
    layer = {"window_s": enc_win["wall_s"] if enc_win else p.encode_s,
             "busy_s": enc_win["busy_s"] if enc_win else None}
    if seen_short(enc_win):
        layer["profiler_missed"] = seen_short(enc_win)

    decode = None
    if "D2" in route.kernels:
        def decode(codec, blobs, imgs):
            out, win, n = windowed(lambda: decode_verify(codec, blobs, imgs),
                                   ("D2",), on_card)
            layer.update(d2_launches=n["D2"], d2_payloads=n["D2 tables"],
                         d2_ms=kernel_ms(win, "D2", n["D2 tables"]))
            if seen_short(win):
                layer["profiler_missed_decode"] = seen_short(win)
            return out
    finish_pass(p, codec, imgs, decode)

    if "K1" in kinds:
        layer.update(k1_layer(enc_win, launches["K1"], st["loops"],
                              st["iters"], launches["K1 scanned"]))
    for kind in ("K3", "K2", "D1"):
        if kind in kinds:
            name = kind.lower()
            layer[f"{name}_launches"] = launches[kind]
            if kind != "D1":
                layer[f"{name}_kernel_launches"] = launches[f"{kind} kernels"]
            layer[f"{name}_ms"] = kernel_ms(enc_win, kind, launches[kind])
    if "K2" in kinds:
        sp = st["spent"]
        wide, native_s = sp.get("wide", 0.0), sp.get("native", 0.0)
        layer.update(k2_route_s=p.encode_s,
                     k2_route_calls_s=wide - sp.get("runs", 0.0),
                     k2_route_runs_s=sp.get("runs", 0.0),
                     k2_route_native_s=native_s,
                     k2_route_adoption_s=p.encode_s - wide - native_s)
    spans = {k: {"calls": n, "s": s} for k, (n, s) in trace.report().items()
             if k.startswith("huffman")}
    if spans:
        layer["huffman_spans"] = spans
    return p, layer


def cluster_colors_stages(codec, imgs, dev, blobs) -> tuple:
    """(cc_* seconds, problems): cluster-colors' four stages by
    `profile_group`, whose streams must equal the encode's."""
    r = profile_group(imgs, codec.n, dev)
    bad = ([] if r["streams"] == blobs else
           [f"{codec.name}: the stages' streams differ from encode_batch's"])
    return {f"cc_{k}_s": v for k, v in r["seconds"].items()}, bad


# --------------------------------------------------------------------------
# a cell
# --------------------------------------------------------------------------

def quartiles(xs) -> dict:
    xs = [x for x in xs if not math.isnan(x)]
    if not xs:
        return {"median": None, "q1": None, "q3": None, "min": None,
                "max": None, "n": 0}
    q1, med, q3 = np.percentile(xs, [25, 50, 75]).tolist()
    return {"median": med, "q1": q1, "q3": q3, "min": min(xs),
            "max": max(xs), "n": len(xs)}


def geomean(xs) -> float:
    xs = list(xs)
    if not xs or min(xs) <= 0:
        return 0.0
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def pass_rates(mp: float, passes) -> tuple:
    """Encode and decode MP/s of each pass, the spread's samples: 0 for a
    pass that failed an image."""
    enc = [0.0 if p.failed else mp / p.encode_s for p in passes]
    dec = [0.0 if p.failed else mp / p.decode_s for p in passes]
    return enc, dec


def route_rates(mp: float, passes) -> tuple:
    """Encode and decode MP/s over all the passes: the megapixels of the
    passes that failed no image over the seconds of every pass."""
    work = mp * sum(not p.failed for p in passes)
    return (work / sum(p.encode_s for p in passes),
            work / sum(p.decode_s for p in passes))


def run_cell(cell: Cell, seed=None, device="cuda", say=print) -> dict:
    """Run one cell; returns its result (the JSON line's object)."""
    dev = resolve_device(device)
    seed = cell.seed if seed is None else seed
    label = bench.device_label(dev.type)
    t_cell = time.perf_counter()
    say(f"cell {cell.name}: config {cell.config}, seed {seed}, "
        f"{cell.passes} timed passes of {cell.images} images, on {label}")
    imgs_of, names = cell_images(cell, seed)
    problems = []
    attempted = failed = 0
    routes, layers = {}, {}
    codecs = {}
    reference = {}
    if any(r.env for r in cell.routes):
        # the ungated streams of the same images, in this run
        for r in cell.routes:
            if r.spec not in reference:
                with gates_on(()):
                    reference[r.spec] = from_spec(
                        r.spec, device=dev.type).encode_batch(imgs_of[r.label])
    for r in cell.routes:
        codecs[r.label] = from_spec(r.spec, device=dev.type)

    def one_pass(r):
        nonlocal attempted, failed
        with gates_on(r.env):
            p = run_pass(codecs[r.label], imgs_of[r.label])
        attempted += len(p.blobs)
        failed += p.failed
        return p

    for r in cell.routes:                      # warmup
        one_pass(r)
    timed = {r.label: [] for r in cell.routes}
    for _ in range(cell.passes):               # closed loop, tracing off
        for r in cell.routes:
            timed[r.label].append(one_pass(r))
    busy = window_s = 0.0
    for r in cell.routes:                      # the traced pass
        codec, imgs = codecs[r.label], imgs_of[r.label]
        with gates_on(r.env):
            p, layer = traced_pass(r, codec, imgs, dev)
            attempted += len(p.blobs)
            failed += p.failed
            if codec.name.startswith("cluster-colors") and not p.failed:
                stages, bad = cluster_colors_stages(codec, imgs, dev,
                                                    p.blobs)
                layer.update(stages)
                problems += bad
        window_s += layer.pop("window_s")
        b = layer.pop("busy_s")
        busy = None if b is None or busy is None else busy + b
        layers[r.label] = layer
        problems += pass_problems(r.label + " (traced)", codec, imgs, p,
                                  timed[r.label][0])

    for r in cell.routes:
        codec, imgs, ps = codecs[r.label], imgs_of[r.label], timed[r.label]
        for i, p in enumerate(ps):
            problems += pass_problems(f"{r.label} (pass {i + 1})", codec,
                                      imgs, p, ps[0] if i else None)
        unlike = None
        if r.env:
            unlike = sum(got != want for got, want in zip(ps[0].blobs,
                                                          reference[r.spec]))
            if "K3" in r.kernels and dev.type == "cuda":  # one schedule
                problems += k3_walker_problems(r.label, codec, imgs, dev)
            if unlike and not r.own_streams:
                problems.append(f"{r.label}: {unlike} gated streams differ "
                                "from the ungated ones")
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        enc, dec = pass_rates(mp, ps)
        enc_mps, dec_mps = route_rates(mp, ps)
        routes[r.label] = {
            "codec": codec.name, "megapixels": mp,
            "encode_mps": enc_mps, "decode_mps": dec_mps,
            "encode_s": quartiles([p.encode_s for p in ps]),
            "decode_s": quartiles([p.decode_s for p in ps]),
            "encode_mps_passes": enc, "decode_mps_passes": dec,
            "failed": sum(p.failed for p in ps)}
        if unlike is not None:
            routes[r.label]["streams_unlike_ungated"] = unlike

    pinned = pins_apply(cell, seed)
    if pinned:
        problems += pin_problems(cell, codecs, imgs_of, timed, names)

    n = cell.passes
    enc_pass = [geomean(v["encode_mps_passes"][i] for v in routes.values())
                for i in range(n)]
    dec_pass = [geomean(v["decode_mps_passes"][i] for v in routes.values())
                for i in range(n)]
    result = {
        "cell": cell.name, "config": cell.config, "seed": seed,
        "passes": n, "images": cell.images, "device": label,
        "encode_mps": geomean(v["encode_mps"] for v in routes.values()),
        "decode_mps": geomean(v["decode_mps"] for v in routes.values()),
        "failed_share": failed / attempted if attempted else 1.0,
        "units": UNITS,
        "spread": {"encode_mps": quartiles(enc_pass),
                   "decode_mps": quartiles(dec_pass)},
        "failed": failed, "attempted": attempted,
        "routes": routes,
        "layers": {"device_idle_share": (None if busy is None else
                                         1.0 - busy / window_s),
                   **layers},
        "pins": "applied" if pinned else "not applied (not the default "
                                         "seed and size)",
        "correct": not problems and failed == 0,
        "problems": problems[:50],
        "seconds": time.perf_counter() - t_cell,
    }
    report(result, say)
    return result


def pin_problems(cell, codecs, imgs_of, timed, names) -> list:
    """The first timed pass's outputs against each of the cell's pins."""
    first = {r.label: timed[r.label][0] for r in cell.routes}
    out = []
    for kind, path in cell.pins:
        if kind == "rows":
            rows = {}
            for r in cell.routes:
                p = first[r.label]
                rows[codecs[r.label].name] = {
                    name: csv_row(b, im, m) for name, b, im, m in zip(
                        names, p.blobs, imgs_of[r.label], p.mses)
                    if m is not None}
            out += rows_problems(rows, names, path)
        elif kind == "full_size":
            seen = {}
            for r in cell.routes:
                p = first[r.label]
                if p.mses[0] is not None:
                    seen[codecs[r.label].name] = full_size_cell(
                        p.blobs[0], imgs_of[r.label][0], p.mses[0])
            out += full_size_problems(seen, path)
        elif kind == "sha256":
            out += hash_problems({
                r.label: [digest(b) if isinstance(b, bytes) else "failed"
                          for b in first[r.label].blobs]
                for r in cell.routes}, path)
        else:
            out.append(f"unknown pin kind {kind!r}")
    return out


def _fmt(v) -> str:
    return "not measured" if v is None else (
        f"{v:.6g}" if isinstance(v, float) else str(v))


def report(res: dict, say=print) -> None:
    """Every metric by name with its unit, one a line."""
    for label, r in res["routes"].items():
        e, d = r["encode_s"], r["decode_s"]
        say(f"  {label}: encode {r['encode_mps']:.3f} MP/s over the passes, "
            f"a pass {_fmt(e['median'])} s median (q1 {_fmt(e['q1'])}, q3 "
            f"{_fmt(e['q3'])}, min {_fmt(e['min'])}, max {_fmt(e['max'])}, "
            f"n {e['n']}); decode {r['decode_mps']:.3f} MP/s over the "
            f"passes, a pass {_fmt(d['median'])} s median (q1 "
            f"{_fmt(d['q1'])}, q3 {_fmt(d['q3'])}, n {d['n']}); "
            f"{r['megapixels']:.4f} MP a pass; failed {r['failed']}")
    for key in ("encode_mps", "decode_mps"):
        s = res["spread"][key]
        say(f"{key} {res[key]:.6g} {UNITS[key]} (geomean of the routes' "
            f"rates over all passes; spread: per pass median "
            f"{_fmt(s['median'])}, q1 "
            f"{_fmt(s['q1'])}, q3 {_fmt(s['q3'])}, n {s['n']})")
    say(f"failed_share {res['failed_share']:.6g} {UNITS['failed_share']} "
        f"({res['failed']} of {res['attempted']})")
    lay = res["layers"]
    say(f"layer device_idle_share {_fmt(lay['device_idle_share'])} (of the "
        "encode windows)")
    for label, metrics in lay.items():
        if label == "device_idle_share":
            continue
        for key, v in metrics.items():
            unit = "" if v is None else _LAYER_UNITS.get(key.split("_")[-1],
                                                         "")
            say(f"layer {key}[{label}] "
                + (json.dumps(v) if isinstance(v, dict) else _fmt(v)) + unit)
    say(f"pins {res['pins']}")
    for msg in res["problems"]:
        say(f"PROBLEM {msg}")
    say(f"correct {str(res['correct']).lower()}")


_LAYER_UNITS = {"ms": " ms", "s": " s", "launches": " launches",
                "iters": " iterations", "payloads": " payloads",
                "share": ""}

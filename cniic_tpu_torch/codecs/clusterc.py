"""The k-means codecs (reference src/codec/clusterc.rs), on an explicit device.

Port of ``cniic_tpu/codecs/clusterc.py``; the streams are byte-identical.

`cluster-colors(n)`: weighted k-means over the image's *unique* colors
(weights = occurrence counts, distance ignores weights, means are
weight-averaged with integer truncation, clusterc.rs:74-113), every pixel
remapped to its cluster centroid, then delegated to the Hufman codec
(clusterc.rs:18-57). Decode IS Hufman decode.

`voronoi(n)`: k-means over all pixels as 5-D (x, y, r, g, b) points
(distance = sqrt(dx^2+dy^2+|drgb|^2), means integer-truncated,
clusterc.rs:206-247); only the dimensions and the k centroids are written
(19 bytes each: u32 x, u32 y, 11-byte Rgb; clusterc.rs:147-166). Decode
rebuilds each pixel from the nearest centroid by the wrapping-u32 2-D
distance (color ignored) — see ops/voronoi.py.

Both take ``device`` ("cuda" or "cpu"); the k-means and the voronoi
decode run there. On a CUDA device cluster-colors' colour histograms and
palette ids run there too (`CardStages`); on the CPU they run in the host
C runtime (`HostStages`). Huffman coding runs on the host, apart from
cluster-colors' Huffman payload under the env gates of ``huffman.py``
(D1 packing, D2 decoding on ``device``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .. import native, resolve_device, specs, wire
from ..ops import color_hist, histogram, kmeans, voronoi
from .base import Codec, pixels_row_major
from .hufman import Hufman


def _palette(centroids, cluster_w):
    """(pal_rank int32[k], freq, leaf): each cluster's id in the reduced
    image's palette, the palette's frequencies and its leaf payloads, from
    the centroids and each cluster's weight (the pixels it holds).

    Distinct centroid colors can merge (several clusters, one color), so
    dedup first.
    """
    palette = centroids.astype(np.uint8)              # means stay in 0..255
    pal_keys = histogram.pack_colors(palette)
    uniq_keys, pal_rank = np.unique(pal_keys, return_inverse=True)
    freq = np.zeros(uniq_keys.size, dtype=np.int64)
    np.add.at(freq, pal_rank, np.asarray(cluster_w).astype(np.int64))
    # drop colors whose clusters are all empty: they never appear in the
    # reduced image, so the delegate Hufman path would not emit a leaf
    # for them
    present = freq > 0
    if not present.all():
        remap = np.cumsum(present) - 1
        pal_rank = remap[pal_rank]
        uniq_keys = uniq_keys[present]
        freq = freq[present]
    leaf = np.frombuffer(
        wire.rgb_stream_to_wire(histogram.unpack_colors(uniq_keys.astype(np.uint32))),
        dtype=np.uint8).reshape(-1, wire.RGB_WIRE_SIZE)
    return pal_rank.astype(np.int32), freq, leaf


def _palette_stream_parts(n: int, counts, inverse, centroids, assignment):
    """(ids, freq, leaf) for the Huffman stream of the reduced image.

    Built straight from the palette statistics — byte-identical to
    Hufman().encode(palette[assignment][inverse]) but skips re-histogramming
    the full reduced image.
    """
    cluster_w = np.bincount(assignment, weights=counts.astype(np.float64),
                            minlength=n)
    pal_rank, freq, leaf = _palette(centroids, cluster_w)
    # per-pixel palette ids in one C gather
    ids = native.gather_i32(inverse, pal_rank[assignment])
    return ids, freq, leaf


def lane_order(uniques) -> list[int]:
    """The lanes in `encode_batch`'s k-means order: by unique-colour count,
    descending (ties keep the images' order). Every lane in a chunk is
    padded to the chunk max and iterates until the chunk's straggler
    converges, so homogeneous chunks waste less; per-lane trajectories are
    independent, so the results do not depend on the grouping."""
    return sorted(range(len(uniques)), key=uniques.__getitem__, reverse=True)


def _unsort(order, sorted_results) -> list:
    results: list = [None] * len(order)
    for pos, i in enumerate(order):
        results[i] = sorted_results[pos]
    return results


def _to_host(t) -> np.ndarray:
    """`t` as a numpy array, copied from a CUDA device through pinned
    memory (PyTorch's host allocator keeps the block for the next batch)."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t).numpy()


class HostStages:
    """`ClusterColors.encode_batch`'s four stages in the host C runtime
    (``device="cpu"``): per-image C histograms (``ops/histogram.py``), one
    ``kmeans_batch`` over the host lanes, the palette ids by a C gather,
    then the Huffman stage. Each stage takes the previous ones' results:
    ``hist(imgs)``, ``kmeans(h)``, ``parts(h, results)``, ``huf(imgs,
    results, parts)``. A lane that failed the k-means yields its exception
    in place of its result, part and stream."""

    def __init__(self, k: int, device) -> None:
        self.k = k
        self.device = device

    def hist(self, imgs):
        return [histogram.color_histogram(pixels_row_major(im)) for im in imgs]

    def uniques(self, h) -> list[int]:
        return [s[0].shape[0] for s in h]

    def kmeans(self, h) -> list:
        order = lane_order(self.uniques(h))
        return _unsort(order, kmeans.kmeans_batch(
            [h[i][0].astype(np.int64) for i in order], self.k,
            weights_list=[h[i][1].astype(np.int64) for i in order],
            on_error="collect", device=self.device))

    def parts(self, h, results) -> list:
        return [None if isinstance(r, Exception) else
                _palette_stream_parts(self.k, s[1], s[2], r[0], r[1])
                for s, r in zip(h, results)]

    def huf(self, imgs, results, parts) -> list:
        from .. import huffman

        ok = [i for i, p in enumerate(parts) if p is not None]
        streams = huffman.batch_encode_streams(
            [parts[i][0] for i in ok], [parts[i][1] for i in ok],
            [parts[i][2] for i in ok], torch_device=self.device)
        out: list = list(results)  # exceptions stay in place
        for i, s in zip(ok, streams):
            out[i] = wire.pack_dims(imgs[i].shape[1], imgs[i].shape[0]) + s
        return out


class CardStages(HostStages):
    """The same stages on the device (any torch device; the codec takes
    them on a CUDA one): the images go up once and one sort gives every
    lane's histogram (``ops/color_hist.py``), K1's lanes are built from it
    on the device (``kmeans.kmeans_lanes``), and each pixel's palette id is
    gathered there; only the ids (int32) and a few small arrays come down
    for the host Huffman stage. The streams are the host stages'."""

    def hist(self, imgs):
        return color_hist.lane_histograms(imgs, self.device)

    def uniques(self, h) -> list[int]:
        return list(h.ns)

    def kmeans(self, h) -> list:
        order = lane_order(h.ns)
        return _unsort(order, kmeans.kmeans_lanes(
            h.colors, h.counts, [(h.starts[i], h.ns[i]) for i in order],
            self.k, on_error="collect"))

    def parts(self, h, results) -> list:
        parts: list = [None] * len(results)
        ok = [i for i, r in enumerate(results) if not isinstance(r, Exception)]
        if not ok:
            return parts
        dev = h.counts.device
        lanes = [(h.starts[i], h.ns[i], results[i][1].to(torch.int64))
                 for i in ok]
        cluster_w = torch.zeros((len(ok), self.k), dtype=torch.int64,
                                device=dev)
        for row, (s, n, a) in zip(cluster_w, lanes):
            row.index_add_(0, a, h.counts[s:s + n])
        pals = [_palette(results[i][0], w)
                for i, w in zip(ok, cluster_w.cpu().numpy())]
        ranks = torch.from_numpy(np.stack([p[0] for p in pals])).to(dev)
        # each unique colour's palette id, then each pixel's
        lut = torch.zeros(h.counts.shape[0], dtype=torch.int32, device=dev)
        for rank, (s, n, a) in zip(ranks, lanes):
            lut[s:s + n] = rank[a]
        ids = _to_host(torch.index_select(lut, 0, h.inverse))
        for i, (_, freq, leaf) in zip(ok, pals):
            o = h.offs[i]
            parts[i] = (ids[o:o + h.npx[i]], freq, leaf)
        return parts


class ClusterColors(Codec):
    def __init__(self, n: int, device="cuda") -> None:
        self.n = int(n)
        self.device = resolve_device(device)

    def stages(self) -> HostStages:
        """`encode_batch`'s stages on this codec's device: `CardStages` on a
        CUDA device (no fallback to the host histogram: a device failure
        raises), `HostStages` on the CPU."""
        cls = CardStages if self.device.type == "cuda" else HostStages
        return cls(self.n, self.device)

    def encode(self, img: np.ndarray) -> bytes:
        out = self._encode_all([img])[0]
        if isinstance(out, Exception):
            raise out
        return out

    def encode_batch(self, imgs) -> list[bytes]:
        """Batched: every image's colour histogram, one lockstep k-means
        over every image's unique colors (lanes freeze as they converge, so
        the results equal `encode`'s), then the host Huffman stage."""
        if len(imgs) <= 1:
            return [self.encode(img) for img in imgs]
        return self._encode_all(imgs)

    def _encode_all(self, imgs) -> list:
        st = self.stages()
        h = st.hist(imgs)
        results = st.kmeans(h)
        return st.huf(imgs, results, st.parts(h, results))

    def decode(self, data) -> np.ndarray:
        return Hufman(device=self.device).decode(data)

    def decode_batch(self, blobs) -> list[np.ndarray]:
        """One stream after another on the calling thread, not `host_map`:
        on the card's host, with each batch decoded on the pool, the next
        batch's encode (whose host Huffman stage runs on the calling
        thread) ran slower, and kmeans-midtex8's `encode_mps` fell 6-11%,
        past the cell's bound (PERF.md §6)."""
        return [self.decode(b) for b in blobs]

    @property
    def name(self) -> str:
        return f"cluster-colors_{self.n}"

    @property
    def is_lossless(self) -> bool:
        return False

    @property
    def pipeline_profitable(self) -> bool:
        return True  # long device k-means stages (base.py)


class VoronoiCluster(Codec):
    # at most this many encode-upload buckets stay pinned on the device: the
    # runner pipeline holds two groups in flight (group N decoding while
    # N+1 encodes in the worker thread), each with a handful of shape
    # buckets at most
    _DEV_CACHE_CAP = 4

    def __init__(self, n: int, device="cuda") -> None:
        self.n = int(n)
        self.device = resolve_device(device)
        # ((h, w), tuple(id(img))) -> (list of original np images, device
        # uint8[B, h, w, 3]): the encode upload kept alive so the fused
        # decode+MSE path can skip re-uploading the originals. Keyed per
        # encode bucket and POPPED by decode_mse_batch (clearing at encode
        # start would let the pipelined worker thread wipe group N's entry
        # before group N's decode read it). The cached list holds strong
        # refs, so while an entry lives its ids cannot be reused — a key
        # match implies object identity. FIFO-evicted at _DEV_CACHE_CAP so
        # stale shapes can't accumulate over a sweep.
        self._dev_imgs: dict = {}

    def _cache_put(self, key, value) -> None:
        # under the runner pipeline this runs in the worker thread while
        # decode_mse_batch pops from the main thread — eviction must
        # tolerate the oldest key vanishing between next(iter()) and pop
        self._dev_imgs[key] = value
        while len(self._dev_imgs) > self._DEV_CACHE_CAP:
            try:
                self._dev_imgs.pop(next(iter(self._dev_imgs)), None)
            except (StopIteration, RuntimeError):
                break

    def _serialize(self, w: int, h: int, centroids: np.ndarray) -> bytes:
        out = bytearray()
        out += wire.pack_dims(w, h)  # same bytes as u32(w)+u32(h), adds the 2^27 cap
        out += wire.pack_u64(self.n)
        for cx, cy, r, g, b in centroids.tolist():
            out += wire.pack_u32(cx)
            out += wire.pack_u32(cy)
            out += wire.pack_rgb(r, g, b)
        return bytes(out)

    def encode(self, img: np.ndarray) -> bytes:
        h, w = img.shape[:2]
        cents, dev = kmeans.voronoi_centroids_batch(
            img[None], self.n, return_device_imgs=True, device=self.device)
        if dev is not None:
            self._cache_put(((h, w), (id(img),)), ([img], dev))
        return self._serialize(w, h, cents[0])

    def encode_batch(self, imgs) -> list[bytes]:
        """Batched: images are bucketed by shape and each bucket runs one
        lockstep k-means over its stacked (x, y, r, g, b) point sets (lanes
        freeze as they converge, so per-image centroids equal `encode`'s).
        Only the uint8 images go to the device and only the (k, 5)
        centroids come back."""
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, im in enumerate(imgs):
            buckets.setdefault(im.shape[:2], []).append(i)
        out: list = [None] * len(imgs)
        for (h, w), idxs in buckets.items():
            cents, dev = kmeans.voronoi_centroids_batch(
                np.stack([imgs[i] for i in idxs]), self.n,
                on_error="collect", return_device_imgs=True,
                device=self.device)
            if dev is not None:
                key = ((h, w), tuple(id(imgs[i]) for i in idxs))
                self._cache_put(key, ([imgs[i] for i in idxs], dev))
            for i, c in zip(idxs, cents):
                # failed lanes carry their exception through to the runner
                out[i] = c if isinstance(c, Exception) else self._serialize(w, h, c)
        return out

    @staticmethod
    def _parse(data):
        r = wire.ByteReader(data)
        w, h = r.dims()
        k = r.u64()
        # each centroid costs exactly 19 wire bytes (u32 x, u32 y, 11-byte
        # Rgb): an untrusted k beyond what the stream can hold must die
        # before the (k, 2) allocation. k == 0 is equally malformed — no
        # encoder produces it (the k-means floor rejects k < 1) and the
        # reference's min_by_key over an empty centroid set panics
        if k == 0 or k > r.remaining() // 19:
            raise wire.WireError(
                f"voronoi centroid count {k} invalid for stream capacity")
        xy = np.empty((k, 2), dtype=np.uint32)
        colors = np.empty((k, 3), dtype=np.uint8)
        for i in range(k):
            xy[i, 0] = r.u32()
            xy[i, 1] = r.u32()
            colors[i] = r.rgb()
        return w, h, xy, colors

    def decode(self, data) -> np.ndarray:
        w, h, xy, colors = self._parse(data)
        return voronoi.reconstruct(xy, colors, w, h, device=self.device)

    def decode_batch(self, blobs) -> list[np.ndarray]:
        """Shape-bucketed reconstruction on the device."""
        parsed = [self._parse(b) for b in blobs]
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, (w, h, _, _) in enumerate(parsed):
            buckets.setdefault((w, h), []).append(i)
        out: list[np.ndarray | None] = [None] * len(blobs)
        for (w, h), idxs in buckets.items():
            imgs = voronoi.reconstruct_batch(
                [parsed[i][2] for i in idxs], [parsed[i][3] for i in idxs],
                w, h, device=self.device)
            for i, im in zip(idxs, imgs):
                out[i] = im
        return out

    def decode_mse_batch(self, blobs, originals):
        """Fused device decode + exact MSE: reconstruction and the integer
        error sums run on the device per shape bucket; only the sums come
        back. Returns (mses, fetch) where fetch() pulls the reconstructed
        images for the PNG-save protocol (bench.rs:50-56) and each MSE equals
        runner.compute_error on the fetched image bit-for-bit."""
        parsed = [self._parse(b) for b in blobs]
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, (w, h, _, _) in enumerate(parsed):
            if originals[i].shape[:2] != (h, w):
                raise ValueError("original/decoded shape mismatch")
            buckets.setdefault((w, h), []).append(i)
        mses: list = [None] * len(blobs)
        fetchers = []
        for (w, h), idxs in buckets.items():
            # reuse the encode upload when these exact images just went up:
            # pop our own entry (cached list holds strong refs, so a key
            # match implies the ids are the same live objects)
            key = ((h, w), tuple(id(originals[i]) for i in idxs))
            cached = self._dev_imgs.pop(key, None)
            if cached is not None:
                orig = cached[1]
            else:
                orig = np.stack([originals[i] for i in idxs])
            m, fetch = voronoi.reconstruct_mse_batch(
                [parsed[i][2] for i in idxs], [parsed[i][3] for i in idxs],
                w, h, orig, device=self.device)
            for i, v in zip(idxs, m):
                mses[i] = v
            fetchers.append((idxs, fetch))

        def fetch_all():
            out: list = [None] * len(blobs)
            for idxs, f in fetchers:
                for i, im in zip(idxs, f()):
                    out[i] = im
            return out

        return mses, fetch_all

    @property
    def name(self) -> str:
        return f"voronoi_{self.n}"

    @property
    def is_lossless(self) -> bool:
        return False

    @property
    def pipeline_profitable(self) -> bool:
        return True  # long device k-means stages (base.py)


def parse_cluster_colors(spec: str, device="cuda") -> ClusterColors:
    """Regex c(luster)?-?col(ors)?\\(N\\) (clusterc.rs:116-141)."""
    m = re.search(r"c(?:luster)?-?col(?:ors)?\((\d+)\)", spec)
    if not m:
        raise specs.OtherParseError("Regex doesn't match")
    return ClusterColors(int(m.group(1)), device=device)


def parse_voronoi(spec: str, device="cuda") -> VoronoiCluster:
    m = re.search(r"voronoi\((\d+)\)", spec)
    if not m:
        raise specs.OtherParseError("Regex doesn't match")
    return VoronoiCluster(int(m.group(1)), device=device)

"""Codec interface (reference src/codec.rs:14-19 `trait Codec`).

Port of ``cniic_tpu/codecs/base.py``, plus `host_map`: the default batch
loops spread a batch's images over the host's CPUs, one image a task, as
the reference's rayon fans its images out (bench.rs:22-27).

Images are numpy ``uint8[H, W, 3]`` arrays; alpha is dropped at load time
(the reference calls ``.to_rgb()`` everywhere). ``encode`` returns the
compressed byte string; ``decode`` accepts anything ByteReader accepts and
returns the reconstructed image or raises :class:`cniic_tpu_torch.wire.WireError`.
"""

from __future__ import annotations

import abc
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# While any of these is set, `host_map` runs its loop on the calling
# thread: the four device gates, under which a codec's calls can reach the
# card (K2 in `Hilbert.encode`, K3 in `Hilbert.encode_batch`, D1 and D2 in
# the Huffman stages), and the zip-back profiling counters of the C
# runtime, which are for one thread only (csrc/cniic_native.c).
SERIAL_GATES = ("CNIIC_CHUNKED_RLE", "CNIIC_PALLAS_RLE",
                "CNIIC_DEVICE_BITPACK", "CNIIC_DEVICE_HUF_DECODE",
                "CNIIC_ZB_PROF")

_pool: ThreadPoolExecutor | None = None
_pool_width = 0
_pool_lock = threading.Lock()


def _shared_pool(width: int) -> ThreadPoolExecutor:
    """The process's pool, `width` threads wide; made anew when the width
    changes. Call with `_pool_lock` held: every submission is made under it,
    so a pool is shut down only between submissions (its queued tasks still
    run)."""
    global _pool, _pool_width
    if _pool_width != width:
        if _pool is not None:
            _pool.shutdown(wait=False)
        _pool = ThreadPoolExecutor(width, thread_name_prefix="host_map")
        _pool_width = width
    return _pool


def host_map(fn, items) -> list:
    """``[fn(x) for x in items]``, each item a task on a pool as wide as the
    CPUs this process may run on (``os.sched_getaffinity``, read at every
    call), so a batch of n items keeps min(CPUs, n) threads busy. The
    results come back in the items' order, and an exception propagates as
    the loop's would: the first failing item's, in the items' order.

    The loop runs on the calling thread with one allowed CPU (a process
    pinned to one core, as `measure_baseline` pins itself), with one item,
    or while any of `SERIAL_GATES` is set. `fn` must be safe to run on
    several threads at once: the host C runtime releases the GIL in every
    call and keeps its scratch buffers per thread."""
    items = list(items)
    cpus = len(os.sched_getaffinity(0))
    if (min(cpus, len(items)) <= 1
            or any(os.environ.get(g, "") not in ("", "0")
                   for g in SERIAL_GATES)):
        return [fn(x) for x in items]
    with _pool_lock:
        pool = _shared_pool(cpus)
        futures = [pool.submit(fn, x) for x in items]
    try:
        return [f.result() for f in futures]
    finally:
        for f in futures:  # after a failure, drop the tasks not yet started
            f.cancel()


class Codec(abc.ABC):
    @abc.abstractmethod
    def encode(self, img: np.ndarray) -> bytes: ...

    @abc.abstractmethod
    def decode(self, data) -> np.ndarray: ...

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @property
    @abc.abstractmethod
    def is_lossless(self) -> bool: ...

    def encode_batch(self, imgs) -> list[bytes]:
        """Encode a batch of images.

        Default: `encode` on each image, spread over the host's CPUs by
        `host_map`. Codecs with lane-/batch-parallel device
        paths (approximate RLE, k-means families) override this to amortize
        dispatch and fill the vector lanes. A batched codec may return an
        Exception instance in place of a stream for an image that failed
        (e.g. the k-means active-cluster floor) so the rest of the batch
        survives; the runner records it as that image's failure.
        """
        return host_map(self.encode, imgs)

    def decode_batch(self, blobs) -> list[np.ndarray]:
        """Decode a batch of streams (default: `decode` on each stream by
        `host_map`; device decoders override to amortize dispatch round
        trips)."""
        return host_map(self.decode, blobs)

    @property
    def pipeline_profitable(self) -> bool:
        """Whether the runner's software pipeline (encode group N+1 in a
        worker thread while group N verifies) helps this codec. True only
        for codecs with long device stages whose waits the host thread can
        hide in. A pure-host codec spreads each batch over every allowed
        CPU itself (`host_map`); on a one-vCPU host it lost to the thread
        handoff (measured r3: voronoi 1.42x faster, cluster-colors 1.19x,
        hufman 0.84x — BENCH_NOTES.md). CNIIC_PIPELINE=1/0 overrides."""
        return False

    def __repr__(self) -> str:  # pragma: no cover
        return f"<codec {self.name}>"


def pixels_row_major(img: np.ndarray) -> np.ndarray:
    """(H*W, 3) view in the reference's pixels() order (row-major, x fastest)."""
    h, w = img.shape[:2]
    return np.ascontiguousarray(img.reshape(h * w, 3))

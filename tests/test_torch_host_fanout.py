"""The host codecs' batch fan-out (`codecs.base.host_map`), on the CPU.

* For the seven host-C specs, `encode_batch`/`decode_batch` on a pool give
  the bytes and images of the per-image loop and of `cniic_tpu`'s codec;
  cluster-colors' host decode, which stays on the calling thread, too.
* An image or stream that fails in the middle of a batch raises what the
  per-image loop raises: the first failure in the batch's order.
* Under each device gate, with one allowed CPU, or with one item, the pool
  is never entered.
* The pool is as wide as the CPUs the process may run on.
* Several threads asking at once for the C runtime and the scan curves
  get one library with its argtypes set and each curve made once.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from cniic_tpu.codecs import from_spec as jax_from_spec
from cniic_tpu_torch import hilbert, native
from cniic_tpu_torch.codecs import base, from_spec
from test_golden_frontier import _synth

HOST_SPECS = ["hufman", "delta", "hilbert(rle)", "hilbert(rle(4))",
              "hilbert(zip)", "zip(dict)", "zip(back)"]
GATES = ["CNIIC_CHUNKED_RLE", "CNIIC_PALLAS_RLE", "CNIIC_DEVICE_BITPACK",
         "CNIIC_DEVICE_HUF_DECODE"]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(15)
    return [_synth(rng, 40, 56), _synth(rng, 48, 48), _synth(rng, 32, 64),
            _synth(rng, 40, 56), _synth(rng, 24, 40)]


@pytest.fixture
def cpus(monkeypatch):
    """Set the CPUs this process may run on, as `host_map` reads them."""
    def allow(n):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(n)))
    allow(4)
    return allow


@pytest.fixture
def entered(monkeypatch):
    """The widths with which `host_map` reached for its pool."""
    calls = []
    real = base._shared_pool

    def spy(width):
        calls.append(width)
        return real(width)
    monkeypatch.setattr(base, "_shared_pool", spy)
    for gate in GATES + ["CNIIC_ZB_PROF"]:
        monkeypatch.delenv(gate, raising=False)
    return calls


@pytest.mark.parametrize("spec", HOST_SPECS)
def test_batches_equal_the_loop_and_cniic_tpu(spec, corpus, cpus, entered):
    port = from_spec(spec, device="cpu")
    ref = jax_from_spec(spec)
    blobs = port.encode_batch(corpus)
    assert entered == [4]
    assert blobs == [port.encode(im) for im in corpus]
    assert blobs == [ref.encode(im) for im in corpus]
    decoded = port.decode_batch(blobs)
    assert entered == [4, 4]
    for im, data, dec in zip(corpus, blobs, decoded):
        np.testing.assert_array_equal(dec, port.decode(data))
        np.testing.assert_array_equal(dec, ref.decode(data))
        if port.is_lossless:
            np.testing.assert_array_equal(dec, im)


def test_cluster_colors_host_decode_stays_serial(corpus, cpus, entered):
    port = from_spec("cluster-colors(8)", device="cpu")
    blobs = port.encode_batch(corpus)
    decoded = port.decode_batch(blobs)
    assert entered == []  # both batch methods are its own
    ref = jax_from_spec("cluster-colors(8)")
    for data, dec in zip(blobs, decoded):
        np.testing.assert_array_equal(dec, port.decode(data))
        np.testing.assert_array_equal(dec, ref.decode(data))


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the test compares what each side raised
        return e
    raise AssertionError("no exception")


@pytest.mark.parametrize("spec", ["hufman", "delta", "hilbert(rle)",
                                  "hilbert(zip)", "zip(dict)", "zip(back)"])
def test_a_bad_stream_raises_what_the_loop_raises(spec, corpus, cpus,
                                                  entered):
    codec = from_spec(spec, device="cpu")
    blobs = codec.encode_batch(corpus)
    # two different faults after a good stream: the first must win
    bad = [blobs[0], blobs[1][: len(blobs[1]) // 2], blobs[2],
           b"\x01" * 5, blobs[4]]
    want = _raised(lambda: [codec.decode(b) for b in bad])
    got = _raised(lambda: codec.decode_batch(bad))
    assert type(got) is type(want)
    assert str(got) == str(want)
    assert entered == [4, 4]


@pytest.mark.parametrize("spec", ["hufman", "zip(back)", "hilbert(rle(4))"])
def test_a_bad_image_raises_what_the_loop_raises(spec, corpus, cpus, entered):
    codec = from_spec(spec, device="cpu")
    bad = [corpus[0], corpus[1][:, :, :2].copy(), corpus[2],
           corpus[3].reshape(-1), corpus[4]]
    want = _raised(lambda: [codec.encode(im) for im in bad])
    got = _raised(lambda: codec.encode_batch(bad))
    assert type(got) is type(want)
    assert str(got) == str(want)
    assert entered == [4]


def test_host_map_keeps_order_and_the_first_failure(cpus, entered):
    def fn(x):
        if x in (5, 9):
            raise KeyError(x)
        return x * x
    assert base.host_map(fn, range(5)) == [0, 1, 4, 9, 16]
    with pytest.raises(KeyError) as e:
        base.host_map(fn, range(12))
    assert e.value.args == (5,)


@pytest.mark.parametrize("gate", GATES + ["CNIIC_ZB_PROF"])
def test_gates_keep_the_loop_serial(gate, corpus, cpus, entered, monkeypatch):
    monkeypatch.setenv(gate, "1")
    imgs = [im[:16, :16].copy() for im in corpus[:2]]
    for spec in HOST_SPECS + ["cluster-colors(4)"]:
        codec = from_spec(spec, device="cpu")
        codec.decode_batch(codec.encode_batch(imgs))
    threads = base.host_map(lambda x: threading.get_ident(), range(6))
    assert set(threads) == {threading.get_ident()}
    assert entered == []


def test_one_cpu_or_one_item_is_serial(corpus, cpus, entered):
    codec = from_spec("zip(dict)", device="cpu")
    assert codec.encode_batch(corpus[:1]) == [codec.encode(corpus[0])]
    cpus(1)
    threads = base.host_map(lambda x: threading.get_ident(), range(6))
    assert threads == [threading.get_ident()] * 6
    blobs = codec.encode_batch(corpus)
    assert blobs == [codec.encode(im) for im in corpus]
    assert entered == []


def test_pool_width_follows_the_affinity(cpus, entered):
    barrier = threading.Barrier(3, timeout=30)

    def meet(x):
        barrier.wait()  # three tasks at once: the pool is at least 3 wide
        return threading.get_ident()
    cpus(3)
    first = base.host_map(meet, range(3))
    assert len(set(first)) == 3 and threading.get_ident() not in first
    assert entered == [3] and base._pool_width == 3
    cpus(5)
    assert len(set(base.host_map(lambda x: threading.get_ident(),
                                 range(40)))) <= 5
    assert entered == [3, 5] and base._pool_width == 5
    cpus(3)
    base.host_map(abs, range(2))
    assert entered == [3, 5, 3] and base._pool_width == 3


def test_first_use_from_many_threads(cpus, entered, monkeypatch):
    """The C runtime's first load and each scan curve's first use, asked
    for by more threads than CPUs with a short switch interval: every
    thread sees the argtypes set, the library is declared once and each
    curve is made once (both slowed, so that the threads arrive together)."""
    monkeypatch.setattr(native, "_lib", None)
    loads = []
    load = native._build.load

    def slow_load(*args):
        loads.append(args[0])
        time.sleep(0.02)
        return load(*args)
    monkeypatch.setattr(native._build, "load", slow_load)
    monkeypatch.delenv("CNIIC_NATIVE_LIB", raising=False)
    made = []
    gilbert = hilbert._PROVIDERS["gilbert"]

    def counted(w, h):
        made.append((w, h))
        time.sleep(0.02)
        return gilbert(w, h)
    monkeypatch.setitem(hilbert._PROVIDERS, "gilbert", counted)
    monkeypatch.delenv("CNIIC_CURVE", raising=False)
    for cache in (hilbert._scan_coords_for, hilbert._scan_indices_for,
                  hilbert._inverse_indices_for):
        cache.cache_clear()
    shapes = [(17 + i % 3, 11 + i % 3) for i in range(48)]
    cpus(16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = base.host_map(
            lambda s: (hilbert.scan_indices(*s).copy(),
                       native.mse_sum_u8(np.full(s, 3, np.uint8),
                                         np.zeros(s, np.uint8))), shapes)
    finally:
        sys.setswitchinterval(interval)
        for cache in (hilbert._scan_coords_for, hilbert._scan_indices_for,
                      hilbert._inverse_indices_for):
            cache.cache_clear()
    assert loads == ["cniic_native"]
    assert sorted(made) == sorted(set(shapes))
    for (w, h), (idx, sse) in zip(shapes, got):
        xy = gilbert(w, h)
        np.testing.assert_array_equal(idx, xy[:, 1].astype(np.int64) * w
                                      + xy[:, 0])
        assert sse == 9 * w * h
    assert entered == [16]

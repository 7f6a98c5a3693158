"""`schedule_sweep`'s three sweeps on tiny images on the CPU, with the
profiler's device time replaced by a count of the kernels it would read:
each chunk and each K yields a reading, and K2's and K3's records at every
chunk are checked against the one-walker schedule's."""

import numpy as np
import torch

from cniic_tpu_torch import schedule_sweep
from cniic_tpu_torch.bench import synth_image


def test_sweeps_read_every_setting(monkeypatch):
    monkeypatch.setattr(schedule_sweep, "device_ms",
                        lambda fn, keys, calls=10: (fn(), len(keys))[1])
    monkeypatch.setattr(schedule_sweep, "WIDE_CHUNKS", (32, 64))
    monkeypatch.setattr(schedule_sweep, "CHUNKS", (32, 64))
    monkeypatch.setattr(schedule_sweep, "KS", (0, 12))
    rng = np.random.default_rng(1)
    cpu = torch.device("cpu")
    imgs = [synth_image(rng, 64, 64) for _ in range(2)]
    assert schedule_sweep.k3_sweep(imgs, cpu) == {32: 3, 64: 3}
    # a 32^2 scan is one route chunk of 1024 pixels
    assert schedule_sweep.k2_sweep([synth_image(rng, 32, 32)], cpu) == {
        32: 4, 64: 4, "one walker": 1}
    assert schedule_sweep.d2_sweep(synth_image(rng, 128, 128), cpu) == {
        0: (1, 1), 12: (2, 2)}

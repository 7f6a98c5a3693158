"""`schedule_sweep`'s two sweeps on tiny images on the CPU, with the
profiler's device time replaced by a count of the kernels it would read:
each chunk and each K yields a reading, and K3's records at every chunk are
checked against the one-walker schedule's."""

import numpy as np
import torch

from cniic_tpu_torch import schedule_sweep
from cniic_tpu_torch.bench import synth_image


def test_sweeps_read_every_setting(monkeypatch):
    monkeypatch.setattr(schedule_sweep, "device_ms",
                        lambda fn, keys, calls=10: (fn(), len(keys))[1])
    monkeypatch.setattr(schedule_sweep, "CHUNKS", (32, 64))
    monkeypatch.setattr(schedule_sweep, "KS", (0, 12))
    rng = np.random.default_rng(1)
    cpu = torch.device("cpu")
    imgs = [synth_image(rng, 64, 64) for _ in range(2)]
    assert schedule_sweep.k3_sweep(imgs, cpu) == {32: 3, 64: 3}
    assert schedule_sweep.d2_sweep(synth_image(rng, 128, 128), cpu) == {
        0: (1, 1), 12: (2, 2)}

"""The colour histograms of a batch of images, on its device.

cluster-colors' device path (``codecs/clusterc.py``; ``ops/histogram.py``
stays the host path for ``device="cpu"``). The images go up into one
buffer, each straight into its slice; each pixel's key is
``lane << 24 | r << 16 | g << 8 | b`` (int32 up to 128 lanes, int64 past
them), and one stable sort over the batch groups the lanes one after the
other, each in ascending colour order. Run starts mark the unique colours,
a cumsum numbers them, and the numbers scattered back to the pixels are
the inverse. Per lane this is ``native.hist_rgb`` exactly: the unique
colours in ascending packed-key order (K1's tail-chunk init depends on
it), int64 counts, and an inverse with ``colors[inverse] == pixels``.

Everything stays on the device; the host reads each lane's unique count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LANE_SHIFT = 24


@dataclasses.dataclass
class LaneHist:
    """A batch's colour histograms on the device, lane after lane.

    Lane b's unique colours are ``colors[starts[b]:starts[b] + ns[b]]``
    with their ``counts``; its pixels are ``inverse[offs[b]:offs[b] +
    npx[b]]``, each the index of its colour in ``colors`` (the batch's
    index: subtract ``starts[b]`` for the lane's own)."""
    colors: torch.Tensor    # int32[U, 3]
    counts: torch.Tensor    # int64[U]
    inverse: torch.Tensor   # int32[N]
    starts: list
    ns: list
    offs: list
    npx: list

    def lane(self, b: int):
        """Lane b on the host as ``histogram.color_histogram`` gives it:
        (colors uint8[u, 3], counts int64[u], inverse int32[n])."""
        s, n = self.starts[b], self.ns[b]
        o, m = self.offs[b], self.npx[b]
        return (self.colors[s:s + n].to(torch.uint8).cpu().numpy(),
                self.counts[s:s + n].cpu().numpy(),
                (self.inverse[o:o + m] - s).cpu().numpy())


def lane_histograms(imgs, dev) -> LaneHist:
    """The colour histogram of each image (uint8[h, w, 3]) of `imgs`,
    computed on `dev`."""
    npx = [im.shape[0] * im.shape[1] for im in imgs]
    offs = np.cumsum([0] + npx[:-1]).tolist()
    n_all = sum(npx)
    # one buffer, each image copied straight into its slice
    pix = torch.empty((n_all, 3), dtype=torch.uint8, device=dev)
    for im, o, n in zip(imgs, offs, npx):
        pix[o:o + n].copy_(torch.from_numpy(
            np.ascontiguousarray(im, dtype=np.uint8).reshape(n, 3)))
    # lane << 24 must stay below 2^31 in int32
    kdt = torch.int32 if len(imgs) <= 128 else torch.int64
    keys = pix[:, 0].to(kdt) << 16
    keys |= pix[:, 1].to(kdt) << 8
    keys |= pix[:, 2].to(kdt)
    del pix  # each buffer goes as soon as it is used: a batch's peak memory
    for b in range(1, len(imgs)):
        keys[offs[b]:offs[b] + npx[b]] |= b << LANE_SHIFT
    sk, pos = torch.sort(keys, stable=True)
    del keys
    change = torch.ones(n_all, dtype=torch.bool, device=dev)
    torch.ne(sk[1:], sk[:-1], out=change[1:])
    seg = torch.cumsum(change, 0, dtype=torch.int32) - 1
    inverse = torch.empty(n_all, dtype=torch.int32, device=dev)
    inverse.scatter_(0, pos, seg)
    del pos, seg
    first = change.nonzero().squeeze(1)
    ukeys = sk[first]
    counts = torch.diff(first, append=first.new_full((1,), n_all))
    ns = torch.bincount(ukeys >> LANE_SHIFT, minlength=len(imgs)).tolist()
    colors = torch.stack([(ukeys >> 16) & 0xFF, (ukeys >> 8) & 0xFF,
                          ukeys & 0xFF], dim=1).to(torch.int32)
    starts = np.cumsum([0] + ns[:-1]).tolist()
    return LaneHist(colors, counts, inverse, starts, ns, offs, npx)

"""cniic-tpu on PyTorch and CUDA: the port of `cniic_tpu` to one NVIDIA H100.

The JAX package `cniic_tpu` stays the reference; this package runs the same
nine codec families (`hufman`, `zip(dict)`, `zip(back)`, `hilbert(rle)`,
`hilbert(rle(d))`, `hilbert(zip)`, `delta`, `cluster-colors(n)`,
`voronoi(n)`) with byte-identical streams, through `codecs.from_spec`,
`runner.measure_all`, the CLI and `bench`, on an explicit device. Its
kernels are CUDA C++ written for Hopper (`sm_90a`, `csrc/`): K1, the fused
k-means assign+stats step; K2 and K3, approximate RLE behind
CNIIC_CHUNKED_RLE=1 / CNIIC_PALLAS_RLE=1; D1 and D2, Huffman bit packing
and chunked decode behind CNIIC_DEVICE_BITPACK=1 /
CNIIC_DEVICE_HUF_DECODE=1. It imports torch and numpy, never jax and never
`cniic_tpu`; the host C runtime is compiled from the reference's one source
file into this package's `_build/` directory (see `_build.py`).

Public API:
    from cniic_tpu_torch import codecs
    codec = codecs.from_spec("voronoi(128)", device="cuda")
    payload = codec.encode(img)          # img: uint8[H, W, 3]
    restored = codec.decode(payload)
"""

__version__ = "0.1.0"


def resolve_device(device):
    """`torch.device` for a user-chosen device; a CUDA device with no card
    raises instead of quietly running on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev

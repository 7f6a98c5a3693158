"""Packaging, I/O, runner and CLI of the PyTorch port.

* importing every module of `cniic_tpu_torch` loads neither jax nor
  `cniic_tpu` (checked in a fresh interpreter);
* the stdlib PNG reader and writer agree with PIL both ways, over gray, RGB
  and RGBA and every filter type;
* `runner.measure_all` writes byte-identical CSVs in both packages;
* the CLI runs with `--device cpu`, calls an unknown spec malformed and
  refuses `--device cuda` with no card, for every codec family.
  (`--special=hilbert` is held against the JAX CLI in test_torch_hilbert.py.)
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from cniic_tpu import runner as jax_runner
from cniic_tpu.codecs import from_spec as jax_from_spec
from cniic_tpu_torch import cli, image_io, runner
from cniic_tpu_torch.codecs import from_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cniic_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py") or "_build" in root:
                continue
            rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
            mod = rel.replace(os.sep, ".")
            mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__")
                        else mod)
    return mods


def test_import_loads_no_jax_and_no_jax_package():
    mods = [m for m in _port_modules() if not m.endswith("__main__")]
    assert "cniic_tpu_torch.ops.kmeans_kernel" in mods
    assert {"cniic_tpu_torch.parallel.mesh", "cniic_tpu_torch.parallel.launch",
            "cniic_tpu_torch.entry"} <= set(mods)
    assert {f"cniic_tpu_torch.{m}" for m in (
        "synth_corpus", "sweep", "measure_baseline", "northstar",
        "convergence_study")} <= set(mods)
    # every script of scripts/experiments/ that imports cniic_tpu has its
    # module here (kmeans_key_census.py is not ported: ROADMAP.md)
    assert {m for m in mods if m.startswith("cniic_tpu_torch.experiments.")
            } == {f"cniic_tpu_torch.experiments.{m}" for m in (
                "fuzz_campaign", "roundtrip_campaign", "profile_clusterc",
                "kmeans_phase_probe", "profile_kmeans", "profile_hufenc",
                "batch_depth_study", "voronoi_probe", "interleave_probe",
                "probe_cleg_scale", "corpus_variance",
                "device_hist_rle_probe", "zipback_matchfinder")}
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cniic_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_native_builds_read_only_the_port_sources(monkeypatch):
    """Every library the port builds (the C runtime, K1+D3, K2+K3, D1+D2)
    compiles sources inside `cniic_tpu_torch/`, never a file of the JAX
    package; the C runtime is the port's own copy of the reference file."""
    from unittest import mock

    from cniic_tpu_torch import _build, native
    from cniic_tpu_torch.ops import approx_rle, bitpack, kmeans_kernel

    seen = {}

    def fake_load(name, sources, commands):
        seen[name] = (list(sources), commands)
        return mock.MagicMock()

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    for mod, fn in ((native, "_load"), (kmeans_kernel, "load_library"),
                    (approx_rle, "load_library"), (bitpack, "load_library")):
        monkeypatch.setattr(mod, "_lib", None)
        getattr(mod, fn)()
    assert sorted(seen) == ["approx_rle", "cniic_native", "huffman_dev",
                            "kmeans_assign"]
    inside = os.path.join(PKG, "")
    for name, (sources, commands) in seen.items():
        assert sources, name
        named = set(sources) | {a for argv in commands for a in argv
                                if a.endswith((".c", ".cu"))}
        for src in named:
            assert os.path.realpath(src).startswith(inside), (name, src)
            assert os.path.exists(src), (name, src)
    assert native._SRC == os.path.join(PKG, "csrc", "cniic_native.c")
    with open(native._SRC, "rb") as a, open(os.path.join(
            REPO, "cniic_tpu", "native", "cniic_native.c"), "rb") as b:
        assert a.read() == b.read()


def test_native_lib_override_is_loaded_as_is(tmp_path, monkeypatch):
    """CNIIC_NATIVE_LIB names a prebuilt C runtime (the ASan fuzz build),
    read at first use, loaded as it is and never built."""
    import shutil

    from cniic_tpu_torch import _build, native

    native._load()  # the library the port builds, copied as the prebuilt one
    alt = tmp_path / "libcniic_alt.so"
    shutil.copy(_build.lib_path("cniic_native"), alt)

    def no_build(*args):
        raise AssertionError("CNIIC_NATIVE_LIB set, but the runtime was built")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CNIIC_NATIVE_LIB", str(alt))  # after the import
    assert native._load()._name == str(alt)
    a = np.arange(30, dtype=np.uint8)
    assert native.mse_sum_u8(a, a[::-1].copy()) == int(
        ((a.astype(np.int64) - a[::-1]) ** 2).sum())
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CNIIC_NATIVE_LIB", str(tmp_path / "missing.so"))
    with pytest.raises(OSError):
        native._load()


def test_convergence_study_big_refused_without_a_card(capsys):
    """`convergence_study big` defaults to the card and is refused without
    one (the sweep's and northstar's refusals are in their own files)."""
    from cniic_tpu_torch import convergence_study

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    assert convergence_study.main(["big"]) == 1
    assert "Device unavailable" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _filtered_png(img: np.ndarray, ftypes) -> bytes:
    """An 8-bit PNG of img ([h, w, c], c in 1, 3, 4) whose row y uses filter
    ftypes[y % len(ftypes)] (the encoder side of the PNG filters)."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        ft = ftypes[y % len(ftypes)]
        row = raw[y]
        left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(ft)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = row
    ctype = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_matches_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (13, 11, channels)).astype(np.uint8)
    img[4:9, 2:7] = 77  # flat patch: Sub/Up/Paeth residues of zero
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, [0, 1, 2, 3, 4]))
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(image_io.load_image(path), want)
    # and a file PIL wrote with its own filter choices
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img if channels > 1 else img[:, :, 0], mode).save(
        path, optimize=True)
    np.testing.assert_array_equal(image_io.load_image(path), want)


def test_png_writer_read_by_pil(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (9, 14, 3)).astype(np.uint8)
    image_io.save_png(img, tmp_path / "o.png")
    with Image.open(tmp_path / "o.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)


@pytest.mark.parametrize("variant", ["palette", "16bit", "interlaced",
                                     "signature", "crc"])
def test_png_reader_refuses_other_variants(tmp_path, variant):
    img = np.zeros((4, 4, 3), np.uint8)
    data = _filtered_png(img, [0])
    if variant == "palette":
        Image.fromarray(img).convert("P").save(tmp_path / "p.png")
        data = (tmp_path / "p.png").read_bytes()
    elif variant in ("16bit", "interlaced"):
        # patch IHDR's bit depth (offset 24) or interlace byte (offset 28)
        off, val = (24, 16) if variant == "16bit" else (28, 1)
        ihdr = bytearray(data[12:29])
        ihdr[off - 12] = val
        data = (data[:12] + bytes(ihdr)
                + struct.pack(">I", zlib.crc32(bytes(ihdr))) + data[33:])
    elif variant == "signature":
        data = b"GIF89a" + data[6:]
    else:
        data = data[:30] + bytes([data[30] ^ 1]) + data[31:]
    with pytest.raises(ValueError):
        image_io.decode_png(data)


# ---------------------------------------------------------------------------
# runner and CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def pngs(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i, (h, w) in enumerate([(24, 32), (24, 32), (20, 28)]):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        img[: h // 2] = img[: h // 2] // 64 * 64  # a few flat colours
        p = tmp_path / f"img{i}.png"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("spec,batch", [("cluster-colors(8)", 1),
                                        ("voronoi(12)", 2),
                                        ("hilbert(rle(4))", 2),
                                        ("hilbert(zip)", 1),
                                        ("hufman", 2),
                                        ("delta", 1),
                                        ("zip(back)", 2)])
def test_measure_all_csv_identical(pngs, tmp_path, spec, batch):
    rj = jax_runner.measure_all(jax_from_spec(spec), pngs,
                                output_dir=str(tmp_path / "jax"),
                                verbose=False, batch=batch)
    rt = runner.measure_all(from_spec(spec, device="cpu"), pngs,
                            output_dir=str(tmp_path / "port"),
                            verbose=False, batch=batch)
    assert rj.failures == [] and rt.failures == []
    name = f"{from_spec(spec, device='cpu').name}.csv"
    jcsv = (tmp_path / "jax" / name).read_bytes()
    assert (tmp_path / "port" / name).read_bytes() == jcsv
    assert len(jcsv.splitlines()) == 1 + len(pngs)
    for p in pngs:  # the decoded images saved for the rows with an error
        stem = os.path.splitext(os.path.basename(p))[0] + ".png"
        saved = (tmp_path / "jax" / stem).exists()
        assert (tmp_path / "port" / stem).exists() == saved
        if not saved:
            continue
        with Image.open(tmp_path / "jax" / stem) as a:
            np.testing.assert_array_equal(
                image_io.load_image(tmp_path / "port" / stem), np.asarray(a))


def test_cli_runs_on_cpu(pngs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--codec=voronoi(12)", "--device", "cpu", "--batch=2"]
                    + pngs) == 0
    assert "3 images ok, 0 failed" in capsys.readouterr().out
    assert (tmp_path / "output" / "voronoi_12.csv").exists()
    assert cli.main(["--codec=ccol(8)", "--device=cpu", pngs[0]]) == 0
    assert cli.main(["--codec=hilbert(rle(4))", "--device", "cpu"] + pngs) == 0
    assert (tmp_path / "output" / "hilbert-rle-approx_4.csv").exists()
    for spec, name in (("hufman", "Hufman"), ("delta", "delta"),
                       ("zip(dict)", "zip-dict"), ("zip(back)", "zip-back")):
        assert cli.main([f"--codec={spec}", "--device", "cpu"] + pngs) == 0
        assert (tmp_path / "output" / f"{name}.csv").exists()


def test_cli_refusals(pngs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main([]) == 1
    assert cli.main(["--codec=bogus", "--device", "cpu", pngs[0]]) == 1
    err = capsys.readouterr().err
    assert "Malformed codec argument" in err and "Device unavailable" not in err
    assert cli.main(["--codec=voronoi(4)", "--device", "tpu", pngs[0]]) == 1
    assert cli.main(["--special=bogus", pngs[0]]) == 1
    assert "Invalid special command" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda is accepted")
    for spec in ("voronoi(4)", "hufman", "delta", "zip(back)"):
        assert cli.main([f"--codec={spec}", pngs[0]]) == 1  # cuda by default
        assert "Device unavailable" in capsys.readouterr().err
    assert not (tmp_path / "output").exists()

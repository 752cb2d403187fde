"""The port's data preparation on the CPU against the JAX package: the
raster tiling (``datasets/convert.py``: tile boxes, the colour-mask table,
converted tiles byte for byte, the channel statistics) and the
``generate_superpixels``, ``convert_datasets`` and ``statistic`` CLIs
against the JAX tools on the same inputs: equal files, equal printed
lines."""

import importlib
import os
import sys

import numpy as np
import pytest

from uemda_tpu.datasets import convert as j_convert
from uemda_tpu_torch.datasets import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALETTE = np.array([[0, 0, 0], [255, 255, 255], [255, 0, 0], [255, 255, 0],
                    [0, 255, 0], [0, 255, 255], [0, 0, 255]], np.uint8)


def _jax_tool(name):
    sys.path.insert(0, ROOT)
    return importlib.import_module(f"tools.{name}")


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    _jax_tool(name).main()


def _files(d):
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for base, _, names in os.walk(d):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _save(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


@pytest.mark.parametrize("h,w,clip", [(1024, 1536, 512), (1000, 1300, 512),
                                      (300, 200, 512), (100, 150, 64)])
def test_clip_boxes_match_jax(h, w, clip):
    """Tiles on multiples and non-multiples of the clip (border tiles
    shifted inward, a raster under the clip one tile of its own size):
    the JAX boxes, every pixel covered, every tile inside the raster."""
    boxes = convert.clip_boxes(h, w, clip)
    assert boxes == j_convert.clip_boxes(h, w, clip)
    cover = np.zeros((h, w), bool)
    for x0, y0, x1, y1 in boxes:
        assert 0 <= x0 < x1 <= w and 0 <= y0 < y1 <= h
        assert (x1 - x0, y1 - y0) == (min(clip, w), min(clip, h))
        cover[y0:y1, x0:x1] = True
    assert cover.all()


def test_color_mask_to_ids_matches_jax():
    """Every ISPRS colour, clutter (red) merged into background, and
    colours outside the table (background too): equal to JAX, uint8."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 7, (40, 56))
    mask = PALETTE[idx]
    mask[:3, :5] = (12, 200, 7)  # not an ISPRS colour
    got = convert.color_mask_to_ids(mask)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_convert.color_mask_to_ids(mask))
    want = np.where(idx == 6, 0, idx)
    want[:3, :5] = 0
    np.testing.assert_array_equal(got, want)


def _rasters(d, rng, ids=("2_10", "2_11"), h=100, w=150):
    """Potsdam-named RGBIR and colour-label rasters."""
    os.makedirs(d, exist_ok=True)
    for tid in ids:
        _save(os.path.join(d, f"top_potsdam_{tid}_RGBIR.tif"),
              rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
        _save(os.path.join(d, f"top_potsdam_{tid}_label.tif"),
              PALETTE[rng.integers(0, 7, (h, w))])


@pytest.mark.parametrize("to_label,channels", [(False, "irrg"),
                                               (False, "rgb"),
                                               (True, "irrg")])
def test_convert_raster_matches_jax_byte_for_byte(tmp_path, to_label,
                                                  channels):
    """One 100 x 150 raster clipped to 64^2 tiles (a non-multiple): the
    same tile names and byte-equal PNGs as the JAX converter."""
    _rasters(tmp_path / "raw", np.random.default_rng(1), ids=("2_10",))
    kind = "label" if to_label else "RGBIR"
    src = str(tmp_path / "raw" / f"top_potsdam_2_10_{kind}.tif")
    convert.convert_raster(src, str(tmp_path / "port"), 64, to_label, channels)
    j_convert.convert_raster(src, str(tmp_path / "jax"), 64, to_label,
                             channels)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and len(got) == 6
    assert "2_10_86_36_150_100.png" in got


def test_compute_channel_stats_matches_jax(tmp_path):
    """Mean and std over two directories of PNGs (a list of dirs, as the
    statistic tool passes): equal to JAX's to 1e-12."""
    rng = np.random.default_rng(2)
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
        for i in range(2):
            _save(str(tmp_path / d / f"t{i}.png"),
                  rng.integers(0, 256, (24, 40, 3), dtype=np.uint8))
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    for arg in (dirs, dirs[0]):
        m, s = convert.compute_channel_stats(arg)
        jm, js = j_convert.compute_channel_stats(arg)
        np.testing.assert_allclose(m, jm, rtol=1e-12)
        np.testing.assert_allclose(s, js, rtol=1e-12)


@pytest.mark.parametrize("algo", ["lsc", "slic"])
def test_generate_superpixels_cli_matches_the_jax_tool(tmp_path, monkeypatch,
                                                       capsys, algo):
    """Two 64 x 80 tiles: the label maps, shrunk maps (uint16 tifs) and
    boundary PNGs byte-equal to the JAX tool's, and the same printed line;
    the shrunk maps are where ``sup_path_for`` looks for them."""
    from uemda_tpu_torch.datasets.io import read_sup, sup_path_for
    from uemda_tpu_torch.tools import generate_superpixels

    img_dir = tmp_path / "data" / "img_dir" / "train"
    os.makedirs(img_dir)
    rng = np.random.default_rng(3)
    for i in range(2):
        img = np.kron(rng.integers(0, 256, (8, 10, 3)), np.ones((8, 8, 1)))
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
        _save(str(img_dir / f"tile_{i:03d}.png"), img.astype(np.uint8))
    out = {}
    for who in ("port", "jax"):
        dst = tmp_path / who / "ann_dir" / "train_sup"
        argv = ["--img-dir", str(img_dir), "--out-dir", str(dst),
                "--iterations", "20", "--algo", algo]
        if who == "port":
            generate_superpixels.main(argv)
        else:
            _run_jax_tool("generate_superpixels", argv, monkeypatch)
        out[who] = (_files(tmp_path / who), capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 6
    sup = tmp_path / "port" / "ann_dir" / "train_sup_shrink" / "tile_000.tif"
    assert sup_path_for(str(tmp_path / "port" / "img_dir" / "train"
                            / "tile_000.png")) == str(sup)
    # the boundary id (64/16)(80/16) = 20 is there; LSC and SLIC make more
    # ids than that on a tile this small, so the map's top id is a real
    # superpixel's (as in JAX; ROADMAP.md C)
    shrunk = read_sup(str(sup))
    assert (shrunk == 20).any() and shrunk.max() > 20


@pytest.mark.parametrize("dataset", ["potsdam", "potsdam_rgb", "vaihingen"])
def test_convert_datasets_cli_matches_the_jax_tool(tmp_path, monkeypatch,
                                                   capsys, dataset):
    """A raw dir with train and val rasters (Potsdam names, or Vaihingen
    ``area`` names): the same tree of byte-equal tiles and the same
    printed lines, the train split's statistics (``--stats``) included."""
    from uemda_tpu_torch.tools import convert_datasets

    raw = tmp_path / "raw"
    rng = np.random.default_rng(4)
    if dataset == "vaihingen":
        os.makedirs(raw)
        for area in ("area1", "area6"):
            _save(str(raw / f"top_mosaic_09cm_{area}.tif"),
                  rng.integers(0, 256, (90, 70, 3), dtype=np.uint8))
            _save(str(raw / f"label_{area}.tif"),
                  PALETTE[rng.integers(0, 7, (90, 70))])
    else:
        _rasters(raw, rng)
    out = {}
    for who in ("port", "jax"):
        argv = [dataset, "--dataset-path", str(raw), "--out-dir",
                str(tmp_path / who), "--clip-size", "64", "--stats"]
        if who == "port":
            convert_datasets.main(argv)
        else:
            _run_jax_tool("convert_datasets", argv, monkeypatch)
        text = capsys.readouterr().out.replace(str(tmp_path / who), "OUT")
        out[who] = (_files(tmp_path / who), text)
    assert out["port"] == out["jax"]
    names = sorted(out["port"][0])
    assert any(n.startswith(os.path.join("img_dir", "train")) for n in names)
    assert any(n.startswith(os.path.join("ann_dir", "val")) for n in names)
    assert "mean:" in out["port"][1]


def test_statistic_cli_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    """Two image dirs: the same printed mean and std lines."""
    from uemda_tpu_torch.tools import statistic

    rng = np.random.default_rng(5)
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
        _save(str(tmp_path / d / "x.png"),
              rng.integers(0, 256, (30, 20, 3), dtype=np.uint8))
    argv = ["--img-dir", str(tmp_path / "a"), str(tmp_path / "b")]
    statistic.main(argv)
    got = capsys.readouterr().out
    _run_jax_tool("statistic", argv, monkeypatch)
    assert got == capsys.readouterr().out
    assert got.startswith("mean: [") and "std:  [" in got

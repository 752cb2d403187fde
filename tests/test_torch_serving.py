"""The port's serving path on the CPU against the JAX package: the padded
predictor schedule, ``device_batches``, ``evaluate_dataset`` with its
palette PNGs, the confusion matrix, the sweep, and the serving CLIs
(``eval --vis --decode-workers``, ``infer_single``, ``infer_dir``,
``serving_gate``, ``run_pipeline --gate``).

Same numpy inputs from a seed and the same weights in both packages
(``models.port.state_dict_from_jax``, or one ``.pth`` both load), ResNet-18,
f32 with TF32 off. The JAX tools compute in bf16 by default; the tests run
them in f32, as the port's CLIs run on the CPU, by wrapping the functions
they call, so that predictions can be held equal. Tolerances: probabilities
atol 1e-4 (``test_torch_infer.py``), fp16 probabilities 1e-3, mIoU 1e-6,
integer outputs (ids, counts, PNGs) exact.
"""

import functools
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, no_tf32, to_nhwc
from uemda_tpu.datasets.augment import normalize as jax_normalize
from uemda_tpu.infer import evaluate as jax_evaluate
from uemda_tpu.infer import slide as jax_slide
from uemda_tpu.ops import metrics as jax_metrics
from uemda_tpu_torch.datasets.augment import normalize
from uemda_tpu_torch.datasets.meta import NORM_STATS, IsprsDA
from uemda_tpu_torch.datasets.synthetic import (
    make_synthetic_dataset,
    synthetic_split,
)
from uemda_tpu_torch.infer import slide
from uemda_tpu_torch.infer.evaluate import device_batches, evaluate_dataset
from uemda_tpu_torch.ops import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ST = NORM_STATS["Vaihingen"]


@pytest.fixture(scope="module")
def models():
    """ResNet-18 at 32^2 tiles: the JAX model and variables, and the port's
    model with the same weights (f32, eval mode, CPU)."""
    no_tf32()
    return jax_and_torch_models("resnet18", hw=32, seed=4)


def _read_png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


@pytest.mark.parametrize("tta", [False, True])
def test_padded_predictor_schedule_matches_jax(models, tta):
    """Five 48^2 images at batch 2 (the last batch padded with a zero
    image), 32^2 tiles (4 windows a batch image): the port's
    ``device_batches`` + ``make_predictor`` against JAX's, the caller
    slicing the valid rows: atol 1e-4; the padded row is computed too."""
    jmodel, variables, tmodel = models
    data = synthetic_split(IsprsDA, n=5, hw=48, seed=11)
    jfn = jax_slide.make_predictor(jmodel, (32, 32), (48, 48), tta=tta,
                                   compute_dtype="float32")
    want = [np.asarray(jfn(variables, jax_normalize(img, ST["mean"],
                                                    ST["std"])))[:n]
            for _, img, n, _ in jax_evaluate.device_batches(data, 2)]
    with slide.make_predictor(tmodel, (32, 32), (48, 48), tta=tta,
                              compute_dtype=torch.float32) as fn:
        got = []
        for _, img, n, _ in device_batches(data, 2, device="cpu"):
            assert img.shape == (2, 3, 48, 48)
            got.append(to_nhwc(fn(normalize(img, ST["mean"], ST["std"]))[:n]))
    assert [g.shape[0] for g in got] == [w.shape[0] for w in want] == [2, 2, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)


@pytest.mark.parametrize("decode_workers", [1, 2])
def test_device_batches_match_jax(decode_workers):
    """Order, padding (zero images to the batch) and ``n`` as JAX's
    ``device_batches``; the labels unpadded, on the device with
    ``with_label``, else the host arrays JAX yields."""
    data = synthetic_split(IsprsDA, n=5, hw=32, seed=12)
    want = list(jax_evaluate.device_batches(data, 2,
                                            decode_workers=decode_workers))
    for with_label in (False, True):
        got = list(device_batches(data, 2, decode_workers=decode_workers,
                                  device="cpu", with_label=with_label))
        assert len(got) == len(want) == 3
        for (gi, gx, gn, gl), (wi, wx, wn, wl) in zip(got, want):
            assert list(gi) == list(wi) and gn == wn
            assert gx.dtype == torch.uint8 and gx.shape == (2, 3, 32, 32)
            np.testing.assert_array_equal(gx.permute(0, 2, 3, 1).numpy(),
                                          np.asarray(wx))
            if with_label:
                assert isinstance(gl, torch.Tensor)
                gl = gl.numpy()
            np.testing.assert_array_equal(gl, wl)
    assert not np.asarray(want[-1][1][1]).any()  # the padded image


def test_evaluate_dataset_with_vis_matches_jax(models, tmp_path):
    """Three 48^2 images at batch 2 (a padded last batch), 32^2 tiles, TTA:
    the summary (per-class IoU, mIoU) equal to JAX's to 1e-6 and the
    palette PNGs of the argmax equal, file by file."""
    jmodel, variables, tmodel = models
    data = synthetic_split(IsprsDA, n=3, hw=48, seed=13)
    kw = dict(tile=(32, 32), tta=True, batch_size=2)
    summary, miou = evaluate_dataset(
        tmodel, data, ST["mean"], ST["std"], compute_dtype=torch.float32,
        device="cpu", vis_dir=str(tmp_path / "port"), **kw)
    j_summary, j_miou = jax_evaluate.evaluate_dataset(
        jmodel, variables, data, ST["mean"], ST["std"],
        compute_dtype="float32", vis_dir=str(tmp_path / "jax"), **kw)
    np.testing.assert_allclose(miou, j_miou, atol=1e-6)
    np.testing.assert_allclose(summary["iou"], j_summary["iou"], atol=1e-6)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        f"tile_{i:03d}.png" for i in range(3)]
    for name in names:
        np.testing.assert_array_equal(_read_png(tmp_path / "port" / name),
                                      _read_png(tmp_path / "jax" / name))


def _bincount_cm(y, p, c, mask=None):
    """The confusion matrix as the port computed it before (bincount)."""
    t, q = y.reshape(-1).long(), p.reshape(-1).long()
    valid = t >= 0 if mask is None else (t >= 0) & mask.reshape(-1)
    idx = torch.where(valid, t * c + q, torch.full_like(t, c * c))
    return torch.bincount(idx, minlength=c * c + 1)[:-1].reshape(c, c)


@pytest.mark.parametrize("shape,c,with_mask", [
    ((3, 17, 19), 6, True), ((2, 64, 64), 7, False), ((1, 5, 3), 2, True)])
def test_confusion_matrix_is_bit_equal_to_bincount_and_jax(shape, c,
                                                            with_mask):
    """Ignore labels (-1) and a ``valid_mask``: the fixed-buffer
    ``index_add_`` counts equal the old ``bincount`` counts and JAX's."""
    rng = np.random.default_rng(sum(shape) + c)
    y = rng.integers(-1, c, size=shape).astype(np.int32)
    p = rng.integers(0, c, size=shape).astype(np.int32)
    mask = rng.random(shape) > 0.3 if with_mask else None
    tm = None if mask is None else torch.from_numpy(mask)
    got = metrics.confusion_matrix(torch.from_numpy(y), torch.from_numpy(p),
                                   c, tm)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), _bincount_cm(torch.from_numpy(y), torch.from_numpy(p), c,
                                  tm).numpy())
    want = jax_metrics.confusion_matrix(
        jnp.asarray(y), jnp.asarray(p), c,
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sweep_through_device_batches_matches_jax(models, tmp_path):
    """The sweep of five 48^2 in-memory images at batch 2 (a padded last
    batch), 32^2 tiles, TTA, f32: fp16 probabilities within 1e-3 of JAX's
    ``generate_pseudo_labels``, in memory and in the ``.npy`` files; every
    file name present, in the dataset's order; the colour PNGs written."""
    from uemda_tpu.infer.pseudo_gen import generate_pseudo_labels as jax_gen
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels

    jmodel, variables, tmodel = models
    data = synthetic_split(IsprsDA, n=5, hw=48, seed=14)
    kw = dict(tile=(32, 32), tta=True, batch_size=2)
    want = jax_gen(jmodel, variables, data, ST["mean"], ST["std"],
                   compute_dtype="float32", **kw)
    got = generate_pseudo_labels(
        tmodel, data, ST["mean"], ST["std"], out_dir=str(tmp_path / "p"),
        color_dir=str(tmp_path / "c"), compute_dtype=torch.float32,
        device="cpu", **kw)
    names = [data.filename(i) for i in range(5)]
    assert list(got) == list(want) == names
    for name in names:
        assert got[name].dtype == np.float16 and got[name].shape == (48, 48, 6)
        np.testing.assert_allclose(got[name].astype(np.float32),
                                   want[name].astype(np.float32), atol=1e-3)
        np.testing.assert_array_equal(np.load(tmp_path / "p" / f"{name}.npy"),
                                      got[name])
    assert sorted(os.listdir(tmp_path / "c")) == names


def _cli_config(tmp_path, n_val=3, hw=48):
    """A tiny config (resnet18, 32^2 tiles, a synthetic IsprsDA val split
    of PNGs, the run directory under tmp_path) as two files, one for each
    package's ``load_config``; a ``.pth`` of a seeded model that both
    packages load; and the val image dir."""
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.train.loop import build_model

    root = tmp_path / "data"
    make_synthetic_dataset(str(root), IsprsDA, n_train=1, n_val=n_val, hw=hw,
                           seed=15, with_sup=False)
    img, ann = root / "img_dir" / "val", root / "ann_dir" / "val"
    files = []
    for pkg in ("uemda_tpu_torch", "uemda_tpu"):
        f = tmp_path / f"cfg_{pkg}.py"
        f.write_text(
            "import dataclasses\n"
            f"from {pkg}.config import PRESETS, SplitConfig\n"
            f"_v = SplitConfig(({str(img)!r},), ({str(ann)!r},), "
            "(120.0, 82.0, 81.0), (55.0, 39.0, 38.0), batch_size=2)\n"
            "CONFIG = dataclasses.replace(PRESETS['2vaihingen'], "
            "model='resnet18', val=_v, test=_v, crop=(32, 32), "
            f"snapshot_dir={str(tmp_path / 'log')!r})\n")
        files.append(str(f))
    model = build_model(load_config(files[0]), "cpu",
                        generator=torch.Generator().manual_seed(7))
    ckpt = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), ckpt)
    return files[0], files[1], ckpt, img


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """One :func:`_cli_config` (three 48^2 images, batch 2: a padded last
    batch) that the CLI tests share, with its run directory."""
    d = tmp_path_factory.mktemp("cli")
    return _cli_config(d) + (d / "log",)


def _jax_tool(name):
    sys.path.insert(0, ROOT)
    return importlib.import_module(f"tools.{name}")


def test_eval_cli_vis_and_decode_workers(cli, tmp_path, capsys):
    """``eval --vis 1 --decode-workers 2 --tta 1 --device cpu`` on a tiny
    config: the palette PNGs in ``<snapshot_dir>/vis-w.pth`` and the mIoU
    equal to JAX's ``evaluate_dataset`` (vis_dir, f32) on the same
    checkpoint; the run's log written to the run directory."""
    from uemda_tpu.config import load_config as jax_load_config
    from uemda_tpu.datasets.base import SegDataset as JaxSegDataset
    from uemda_tpu.models.port_torch import load_torch_state_dict, port_deeplabv2
    from uemda_tpu.train.loop import build_model as jax_build_model
    from uemda_tpu_torch.tools import eval as eval_cli

    cfg_file, jcfg_file, ckpt, img, log = cli
    eval_cli.main(["--config-path", cfg_file, "--ckpt-path", ckpt,
                   "--tta", "1", "--vis", "1", "--decode-workers", "2",
                   "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = jax_load_config(jcfg_file)
    split = cfg.val
    _, j_miou = jax_evaluate.evaluate_dataset(
        jax_build_model(cfg), port_deeplabv2(load_torch_state_dict(ckpt)),
        JaxSegDataset(cfg.meta, list(split.image_dir), list(split.mask_dir)[0]),
        split.mean, split.std, tile=cfg.crop, tta=True, batch_size=2,
        vis_dir=str(tmp_path / "jax_vis"), compute_dtype="float32")
    np.testing.assert_allclose(out["miou"], j_miou, atol=1e-6)
    vis = log / "vis-w.pth"
    names = sorted(os.listdir(tmp_path / "jax_vis"))
    assert sorted(os.listdir(vis)) == names and len(names) == 3
    for name in names:
        np.testing.assert_array_equal(_read_png(vis / name),
                                      _read_png(tmp_path / "jax_vis" / name))
    assert any(f.endswith(".log") for f in os.listdir(log))


@pytest.mark.parametrize("slide_flag", ["0", "1"])
def test_infer_single_matches_the_jax_tool(cli, tmp_path, monkeypatch,
                                           slide_flag):
    """``infer_single`` on one 48^2 PNG with TTA (``--slide 1``: 32^2
    windows; ``--slide 0``: one forward of the whole image): the ids, colour
    and ground-truth PNGs equal to the JAX tool's on the same ``.pth``
    (driven through ``sys.argv``, computing in f32)."""
    from uemda_tpu_torch.tools import infer_single

    cfg_file, jcfg_file, ckpt, img, _ = cli
    image = str(img / "tile_000.png")
    jtool = _jax_tool("infer_single")
    monkeypatch.setattr(jtool, "make_predictor", functools.partial(
        jtool.make_predictor, compute_dtype="float32"))
    args = ["--ckpt-path", ckpt, "--image-path", image, "--tta", "1",
            "--slide", slide_flag]
    monkeypatch.setattr(sys, "argv", ["infer_single.py", "--config-path",
                                      jcfg_file, "--out-dir",
                                      str(tmp_path / "jax")] + args)
    jtool.main()
    infer_single.main(args + ["--config-path", cfg_file, "--out-dir",
                              str(tmp_path / "port"), "--device", "cpu"])
    for suffix in ("_ids.png", "_color.png", "_gt.png"):
        np.testing.assert_array_equal(
            _read_png(tmp_path / "port" / f"tile_000{suffix}"),
            _read_png(tmp_path / "jax" / f"tile_000{suffix}"))


def test_infer_dir_matches_the_jax_tool(cli, tmp_path, monkeypatch, capsys):
    """``infer_dir`` over three 48^2 PNGs at batch 2 (a padded last batch)
    with ``--decode-workers 2``: every ids and colour PNG equal to the JAX
    tool's on the same ``.pth`` (f32), and the closing line."""
    from uemda_tpu_torch.tools import infer_dir

    cfg_file, jcfg_file, ckpt, img, _ = cli
    jtool = _jax_tool("infer_dir")
    monkeypatch.setattr(jtool, "make_predictor", functools.partial(
        jtool.make_predictor, compute_dtype="float32"))
    args = ["--ckpt-path", ckpt, "--img-dir", str(img), "--batch-size", "2",
            "--decode-workers", "2"]
    monkeypatch.setattr(sys, "argv", ["infer_dir.py", "--config-path",
                                      jcfg_file, "--out-dir",
                                      str(tmp_path / "jax")] + args)
    jtool.main()
    capsys.readouterr()
    infer_dir.main(args + ["--config-path", cfg_file, "--out-dir",
                           str(tmp_path / "port"), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"3 images -> {tmp_path / 'port'} in ")
    assert line.endswith(" img/s)")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 6
    for name in names:
        np.testing.assert_array_equal(_read_png(tmp_path / "port" / name),
                                      _read_png(tmp_path / "jax" / name))


def test_unported_serving_flags_are_refused(cli, tmp_path, monkeypatch):
    """The serving flags once refused (the name is kept from then) run:
    ``infer_single --raster 1`` (the row-sharded raster predictor, one
    process on the CPU) writes the ids, colour and ground-truth PNGs of
    the JAX tool's ``--raster 1`` (over the test's 8 virtual devices, f32);
    ``infer_dir --num-devices 2 --device cpu`` writes, from 2 gloo
    processes, the files of the 1-process run."""
    import uemda_tpu.infer.raster as jax_raster
    from uemda_tpu_torch.tools import infer_dir, infer_single

    cfg_file, jcfg_file, ckpt, img, _ = cli
    image = str(img / "tile_000.png")
    monkeypatch.setattr(jax_raster, "make_raster_predictor", functools.partial(
        jax_raster.make_raster_predictor, compute_dtype="float32"))
    args = ["--ckpt-path", ckpt, "--image-path", image, "--raster", "1"]
    monkeypatch.setattr(sys, "argv", ["infer_single.py", "--config-path",
                                      jcfg_file, "--out-dir",
                                      str(tmp_path / "jax")] + args)
    _jax_tool("infer_single").main()
    infer_single.main(args + ["--config-path", cfg_file, "--out-dir",
                              str(tmp_path / "port"), "--device", "cpu"])
    for suffix in ("_ids.png", "_color.png", "_gt.png"):
        np.testing.assert_array_equal(
            _read_png(tmp_path / "port" / f"tile_000{suffix}"),
            _read_png(tmp_path / "jax" / f"tile_000{suffix}"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    common = ["--config-path", cfg_file, "--ckpt-path", ckpt, "--img-dir",
              str(img), "--batch-size", "2", "--device", "cpu"]
    infer_dir.main(common + ["--out-dir", str(tmp_path / "one")])
    assert infer_dir.main(common + ["--out-dir", str(tmp_path / "two"),
                                    "--num-devices", "2"]) is None
    names = sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "two")) == names and len(names) == 6
    for name in names:
        np.testing.assert_array_equal(_read_png(tmp_path / "two" / name),
                                      _read_png(tmp_path / "one" / name))


HAND_BUILT = {
    "standard": {"miou": 0.5, "iou": [0.4, 0.5, 0.6],
                 "class_names": ["a", "b", "c"]},
    "fastpath": {"miou": 0.5, "iou": [0.4, 0.5, 0.6],
                 "class_names": ["a", "b", "c"]},
    "fastpath_int8": {"miou": 0.497, "iou": [0.41, 0.47, 0.611],
                      "class_names": ["a", "b", "c"]},
    "int8": {"miou": 0.49, "iou": [0.3, 0.5, 0.67],
             "class_names": ["a", "b", "c"]},
}


@pytest.mark.parametrize("tol,class_tol", [(0.005, 0.02), (0.02, 0.2),
                                           (0.005, 0.2)])
def test_serving_gate_decisions_match_jax(monkeypatch, capsys, tol,
                                          class_tol):
    """On hand-built per-mode results: ``deltas_vs_standard``, ``run_gate``'s
    ok and report, and the CLI's exit code equal JAX's."""
    from uemda_tpu_torch.tools import serving_gate

    jtool = _jax_tool("serving_gate")
    assert serving_gate.deltas_vs_standard(HAND_BUILT) == \
        jtool.deltas_vs_standard(HAND_BUILT)
    fake = lambda *a, **k: HAND_BUILT  # noqa: E731
    monkeypatch.setattr(serving_gate, "gate_checkpoint", fake)
    monkeypatch.setattr(jtool, "gate_checkpoint", fake)
    monkeypatch.setattr("uemda_tpu_torch.train.loop.build_model",
                        lambda *a, **k: None)
    monkeypatch.setattr("uemda_tpu.train.loop.build_model",
                        lambda *a, **k: None)
    monkeypatch.setattr("uemda_tpu.train.loop.init_variables",
                        lambda *a, **k: None)
    kw = dict(tolerance=tol, class_tolerance=class_tol)
    got = serving_gate.run_gate("2vaihingen", ["a.pth", "b.pth"], **kw)
    want = jtool.run_gate("2vaihingen", ["a.pth", "b.pth"], **kw)
    assert got == want
    codes = []
    argv = ["--ckpt-path", "a.pth", "--tolerance", str(tol),
            "--class-tolerance", str(class_tol)]
    with pytest.raises(SystemExit) as e:
        serving_gate.main(argv)
    codes.append(e.value.code)
    monkeypatch.setattr(sys, "argv", ["serving_gate.py"] + argv)
    with pytest.raises(SystemExit) as e:
        jtool.main()
    codes.append(e.value.code)
    assert codes[0] == codes[1] == (0 if got[0] else 1)
    assert capsys.readouterr().out.count("GATE_RESULT ") == 4


def test_serving_gate_cli_matches_the_jax_tool(cli, monkeypatch, capsys):
    """The gate CLI on a tiny checkpoint with ``--modes standard,fastpath``
    (f32 on the CPU): per-mode mIoU equal to the JAX tool's (f32) within
    1e-6, one JSON line a mode, a passing GATE_RESULT and exit code 0."""
    import jax.numpy as jjnp

    import uemda_tpu.infer.evaluate as jev
    import uemda_tpu.infer.fastpath as jfp
    from uemda_tpu_torch.tools import serving_gate

    cfg_file, jcfg_file, ckpt, _, _ = cli
    jtool = _jax_tool("serving_gate")
    monkeypatch.setattr(jev, "evaluate_dataset", functools.partial(
        jev.evaluate_dataset, compute_dtype="float32"))
    monkeypatch.setattr(jfp, "build_fastpath", functools.partial(
        jfp.build_fastpath, dtype=jjnp.float32))
    argv = ["--ckpt-path", ckpt, "--modes", "standard,fastpath"]

    def run(fn):
        with pytest.raises(SystemExit) as e:
            fn()
        lines = capsys.readouterr().out.strip().splitlines()
        rows = [json.loads(l) for l in lines if l.startswith("{")]
        result = json.loads(lines[-1].split(" ", 1)[1])
        return e.value.code, {r["mode"]: r["miou"] for r in rows}, result

    code, got, res = run(lambda: serving_gate.main(
        argv + ["--config-path", cfg_file, "--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["serving_gate.py", "--config-path",
                                      jcfg_file] + argv)
    j_code, want, j_res = run(jtool.main)
    assert code == j_code == 0 and res["ok"] and j_res["ok"]
    assert sorted(got) == sorted(want) == ["fastpath", "standard"]
    for mode in got:
        np.testing.assert_allclose(got[mode], want[mode], atol=1e-6)


def test_run_pipeline_gate_runs_on_the_stage_best_checkpoints(tmp_path,
                                                              monkeypatch):
    """``run_pipeline --gate 1``: with ``--dry-run`` the gate command names
    every stage's best checkpoint; in a run it names those that exist, with
    the two tolerances and the device; with none, it exits."""
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.tools import run_pipeline

    cfg_file, _, _, _ = _cli_config(tmp_path, n_val=1, hw=32)
    log = load_config(cfg_file).snapshot_dir
    cmds = []
    monkeypatch.setattr(run_pipeline, "run", lambda cmd, dry: cmds.append(cmd))
    base = ["--config-path", cfg_file, "--gate", "1", "--device", "cpu",
            "--gate-tolerance", "0.01", "--gate-class-tolerance", "0.03"]
    run_pipeline.main(base + ["--dry-run"])
    gate = cmds[-1]
    assert gate[2] == "uemda_tpu_torch.tools.serving_gate"
    assert gate[gate.index("--ckpt-path") + 1].split(",") == [
        f"{log}/{s}/Vaihingen_best.pth" for s in ("src", "align", "ssl")]
    cmds.clear()
    with pytest.raises(SystemExit, match="no stage-best"):
        run_pipeline.main(base + ["--steps", "9"])
    os.makedirs(f"{log}/align")
    open(f"{log}/align/Vaihingen_best.pth", "wb").close()
    run_pipeline.main(base + ["--steps", "9"])
    assert len(cmds) == 1
    gate = cmds[0]
    assert gate[gate.index("--ckpt-path") + 1] == \
        f"{log}/align/Vaihingen_best.pth"
    assert gate[gate.index("--tolerance") + 1] == "0.01"
    assert gate[gate.index("--class-tolerance") + 1] == "0.03"
    assert gate[-2:] == ["--device", "cpu"]

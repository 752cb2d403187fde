"""The port's serving pipeline around the model against the JAX package, on
the CPU: resize and pooling matrices, slide windows and 8-view TTA, the
confusion matrix and mIoU summary, ``evaluate_dataset`` and the eval CLI."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, no_tf32, to_nhwc, to_torch
from uemda_tpu.infer import slide as jax_slide
from uemda_tpu.infer.evaluate import evaluate_dataset as jax_evaluate_dataset
from uemda_tpu.ops import metrics as jax_metrics
from uemda_tpu.ops import resize as jax_resize
from uemda_tpu_torch.datasets.meta import NORM_STATS, IsprsDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset, synthetic_split
from uemda_tpu_torch.infer import slide
from uemda_tpu_torch.infer.evaluate import evaluate_dataset
from uemda_tpu_torch.infer.fastpath import build_fastpath
from uemda_tpu_torch.ops import metrics, resize


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw_in,hw_out", [((5, 7), (16, 12)), ((16, 16), (4, 6))])
def test_resize_bilinear_matches_jax(align_corners, hw_in, hw_out):
    """Separable interpolation matrices, f32: 1e-6."""
    x = _rand((2,) + hw_in + (3,), 1)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), hw_out,
                                                 align_corners=align_corners))
    got = to_nhwc(resize.resize_bilinear(to_torch(x), hw_out, align_corners))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_adaptive_pools_match_jax():
    """Per-scale pooling and the one-GEMM pyramid at the PPM scales, on a
    map whose bins do not divide evenly: 1e-6."""
    x = _rand((2, 13, 11, 8), 2)
    for s in (1, 2, 3, 6):
        want = np.asarray(jax_resize.adaptive_avg_pool(jnp.asarray(x), s))
        got = to_nhwc(resize.adaptive_avg_pool(to_torch(x), s))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    want = jax_resize.adaptive_avg_pool_multi(jnp.asarray(x), (1, 2, 3, 6))
    got = resize.adaptive_avg_pool_multi(to_torch(x), (1, 2, 3, 6))
    assert sorted(got) == sorted(want)
    for s in want:
        np.testing.assert_allclose(to_nhwc(got[s]), np.asarray(want[s]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hw,tile,overlap", [
    ((96, 96), (64, 64), 0.5), ((1024, 1024), (512, 512), 0.5),
    ((500, 700), (512, 512), 0.5), ((130, 257), (64, 32), 0.25),
])
def test_window_grid_identical(hw, tile, overlap):
    assert slide.window_grid(hw, tile, overlap) == \
        jax_slide.window_grid(hw, tile, overlap)


def test_tta_views_match_jax():
    """The 8 dihedral views and their inverse mean, exactly."""
    x = _rand((2, 6, 6, 3), 3)
    want = np.asarray(jax_slide._views(jnp.asarray(x)))
    got = slide._views(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(), want)
    back = slide._unviews(got)
    np.testing.assert_allclose(back.permute(0, 2, 3, 1).numpy(), x, atol=1e-6)


def test_slide_tta_predictor_matches_jax():
    """make_predictor(tta=True): a 96x96 image, 64^2 tiles (4 windows x 8
    views in one forward), the same ResNet-18 weights in both packages, f32
    (TF32 off): atol 1e-4."""
    no_tf32()
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", hw=64, seed=2)
    img = _rand((1, 96, 96, 3), 4)
    jfn = jax_slide.make_predictor(jmodel, (64, 64), (96, 96), tta=True,
                                   compute_dtype="float32")
    want = np.asarray(jfn(variables, jnp.asarray(img)))
    fn = slide.make_predictor(tmodel, (64, 64), (96, 96), tta=True,
                              compute_dtype=torch.float32)
    got = to_nhwc(fn(to_torch(img)))
    assert got.shape == want.shape == (1, 96, 96, 6)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_confusion_matrix_and_summary_match_jax():
    """Counts exact (ignored pixels dropped); IsprsDA summary drops class 0
    from the means and agrees to 1e-6."""
    rng = np.random.default_rng(5)
    y = rng.integers(-1, 6, size=(3, 17, 19)).astype(np.int32)
    p = rng.integers(0, 6, size=(3, 17, 19)).astype(np.int32)
    mask = rng.random((3, 17, 19)) > 0.2
    want = np.asarray(jax_metrics.confusion_matrix(jnp.asarray(y), jnp.asarray(p),
                                                   6, jnp.asarray(mask)))
    got = metrics.confusion_matrix(torch.from_numpy(y), torch.from_numpy(p), 6,
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    kw = dict(class_names=IsprsDA.class_names,
              ignore_labels=list(IsprsDA.eval_ignore_labels))
    s_want = jax_metrics.PixelMetricSummary(6, **kw).summarize(want)
    s_got = metrics.PixelMetricSummary(6, **kw).summarize(got)
    assert s_got["class_names"] == s_want["class_names"] == IsprsDA.class_names[1:]
    for k in ("iou", "f1", "precision", "recall", "miou", "mf1", "mprecision",
              "mrecall"):
        np.testing.assert_allclose(s_got[k], s_want[k], atol=1e-6, err_msg=k)


def test_evaluate_dataset_matches_jax():
    """The whole eval slice on a synthetic IsprsDA split: slide + TTA
    through the fused-stem fast path, confusion matrix, mIoU. Same weights
    and images in both packages, f32; predictions agree, so the summaries
    agree to 1e-6."""
    no_tf32()
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", hw=64, seed=2)
    data = synthetic_split(IsprsDA, n=3, hw=96, seed=1)
    st = NORM_STATS["Vaihingen"]
    summary, miou = evaluate_dataset(
        build_fastpath(tmodel, dtype=torch.float32), data,
        st["mean"], st["std"], tile=(64, 64), tta=True, batch_size=2,
        compute_dtype=torch.float32, device="cpu")
    j_summary, j_miou = jax_evaluate_dataset(
        jmodel, variables, data, st["mean"], st["std"], tile=(64, 64),
        tta=True, batch_size=2, compute_dtype="float32")
    assert 0.0 <= miou <= 1.0
    np.testing.assert_allclose(miou, j_miou, atol=1e-6)
    np.testing.assert_allclose(summary["iou"], j_summary["iou"], atol=1e-6)


def test_synthetic_images_match_jax():
    """The port's copy of the synthetic renderer draws the same labels and
    images from the same seed."""
    from uemda_tpu.datasets import synthetic as jax_synthetic
    from uemda_tpu_torch.datasets import synthetic

    got = [np.random.default_rng(9), np.random.default_rng(9)]
    lab = [m._blocky_labels(r, 64, 6) for m, r in
           zip((synthetic, jax_synthetic), got)]
    np.testing.assert_array_equal(lab[0], lab[1])
    img = [m._render(r, lab[0], 6, shift=7.0) for m, r in
           zip((synthetic, jax_synthetic), got)]
    np.testing.assert_array_equal(img[0], img[1])


def test_config_presets_match_jax():
    """Every preset the JAX package resolves gives the port the same
    dataset, splits (dirs, mean/std, batch size), backbone and tile."""
    from uemda_tpu import config as jax_config
    from uemda_tpu_torch import config

    assert sorted(config.PRESETS) == sorted(jax_config.PRESETS)
    for name in list(jax_config.PRESETS) + ["st.uemda.2vaihingen",
                                            "st.proca.pRgb2potsdam"]:
        got, want = config.load_config(name), jax_config.load_config(name)
        assert (got.name, got.datasets, got.model, got.crop) == \
            (want.name, want.datasets, want.model, want.crop)
        for split in ("val", "test"):
            g, w = getattr(got, split), getattr(want, split)
            assert (g.image_dir, g.mask_dir, g.mean, g.std, g.batch_size) == \
                (w.image_dir, w.mask_dir, w.mean, w.std, w.batch_size)
        assert got.meta.class_names == want.meta.class_names
        assert got.meta.eval_ignore_labels == want.meta.eval_ignore_labels


def test_eval_cli_runs_on_cpu(tmp_path, capsys):
    """python -m uemda_tpu_torch.tools.eval on a synthetic split written as
    PNGs, a user config file and the port's .npz checkpoint, --device cpu:
    prints one JSON line, with the same mIoU with and without --fastpath."""
    from uemda_tpu_torch.models.port import save_npz
    from uemda_tpu_torch.tools import eval as eval_cli

    root = tmp_path / "data"
    make_synthetic_dataset(str(root), IsprsDA, n_train=1, n_val=2, hw=64, seed=3)
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from uemda_tpu_torch.config import PRESETS, SplitConfig\n"
        "_v = SplitConfig(({img!r},), ({ann!r},), (120.0, 82.0, 81.0), "
        "(55.0, 39.0, 38.0), batch_size=2)\n"
        "CONFIG = dataclasses.replace(PRESETS['2vaihingen'], model='resnet18', "
        "val=_v, test=_v, crop=(64, 64), snapshot_dir={log!r})\n".format(
            img=str(root / "img_dir" / "val"), ann=str(root / "ann_dir" / "val"),
            log=str(tmp_path / "log")))
    # weights from a seeded generator: drawn from the process's global RNG,
    # they would depend on the tests run before in the same worker
    model = eval_cli.build_model(eval_cli.load_config(str(cfg_file)), "cpu",
                                 generator=torch.Generator().manual_seed(0))
    ckpt = save_npz(str(tmp_path / "w.npz"), model.state_dict())
    outs = {}
    for fastpath in ("0", "1"):
        eval_cli.main(["--config-path", str(cfg_file), "--ckpt-path", ckpt,
                       "--tta", "1", "--fastpath", fastpath, "--device", "cpu"])
        outs[fastpath] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= outs["0"]["miou"] <= 1.0
    np.testing.assert_allclose(outs["1"]["miou"], outs["0"]["miou"], atol=1e-5)

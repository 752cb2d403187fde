"""``init_prototypes`` and the stage-2 step of the port on the CPU against the
JAX package: the prototype accumulation pass (and that it leaves the
BatchNorm statistics alone), three ``make_align_step`` steps with CORAL and
refine mode 'all', and the ``init_prototypes`` and ``train_align_uem``
twins end to end on synthetic PNGs and ``.tif`` superpixel maps."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, jax_aug_draws
from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from uemda_tpu.alignment.prototypes import init_avg as jax_init_avg
from uemda_tpu.train.lr import poly_warmup_schedule as jax_schedule
from uemda_tpu.train.optim import make_optimizer
from uemda_tpu.train.state import create_train_state
from uemda_tpu.train.steps import StageHParams as JaxHParams
from uemda_tpu.train.steps import make_align_step as jax_make_align_step
from uemda_tpu.train.steps import make_init_proto_step as jax_make_init_proto_step
from uemda_tpu_torch.alignment.prototypes import init_avg
from uemda_tpu_torch.config import PRESETS
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.synthetic import grid_superpixels, make_synthetic_dataset
from uemda_tpu_torch.models import heads as torch_heads
from uemda_tpu_torch.models.port import state_dict_from_jax
from uemda_tpu_torch.train.loop import build_state
from uemda_tpu_torch.train.steps import (
    StageHParams,
    StepDraws,
    make_align_step,
    make_init_proto_step,
)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

C, HW, CROP, K = 6, 72, 64, 512
LR = 1e-3
NORM = dict(src_mean=(128.0,) * 3, src_std=(64.0,) * 3,
            tgt_mean=(120.0,) * 3, tgt_std=(60.0,) * 3)
# low cutoffs: a random-weight model is unsure, and the pseudo labels and
# the target's PCL term should not be all ignore
HP = dict(class_num=C, crop=(CROP, CROP), align_domain=True,
          compute_dtype="float32", refine=True, refine_mode="all",
          cutoff_top=0.5, cutoff_low=0.2, max_segments=64, **NORM)


def _batches(seed, b=2):
    r = np.random.default_rng(seed)
    # 32-pixel class blocks: most 16x16 cells of a crop hold one class to
    # the 75% the downscaled label needs
    label = np.kron(r.integers(0, C, (b, 3, 3)),
                    np.ones((32, 32), np.int64))[:, :HW, :HW].astype(np.int32)
    label[:, :4] = -1
    palette = np.linspace(40, 215, C)[:, None] * np.array([[1.0, 0.8, 0.6]])
    img = np.clip(palette[label.clip(0)] + r.normal(0, 8, label.shape + (3,)),
                  0, 255).astype(np.uint8)
    tgt = np.clip(img[::-1].astype(np.float32) + 20, 0, 255).astype(np.uint8)
    sup = np.stack([np.roll(grid_superpixels(80), (i * 5, i * 3), (0, 1))[:HW, :HW]
                    for i in range(b)]).astype(np.int32)
    return img, label, tgt, sup


def _no_dropout(monkeypatch):
    """Dropout off on both sides, as tests/test_ref_golden_model.py:115-117."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(torch_heads.Dropout, "forward",
                        lambda self, x, generator=None, mask=None: x)


def _states(variables, tmodel, prototypes=None, stop=40):
    jstate = create_train_state(
        jax.tree.map(jnp.asarray, variables),
        make_optimizer(jax_schedule(LR, stop)), C, feat_channels=K,
        prototypes=None if prototypes is None else jnp.asarray(prototypes))
    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                              learning_rate=LR)
    state = build_state(tmodel, cfg, stop, prototypes=prototypes,
                        feat_channels=K)
    return jstate, state


def test_init_proto_step_matches_jax_and_keeps_batch_stats(monkeypatch):
    """Two accumulation batches from the same weights and augmentation
    draws (the JAX step's keys): class counts exact, sums and the averaged
    prototypes to 1e-4 relative of their largest entry (train-mode f32
    features through another framework's convs, summed over up to 32
    pixels); every BatchNorm buffer of the port is unchanged, as JAX
    discards the forward's new statistics (``steps.py:174-180``)."""
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", CROP, seed=2)
    jstate, state = _states(variables, tmodel)
    jstep = jax_make_init_proto_step(jmodel, JaxHParams(**HP))
    step = make_init_proto_step(tmodel, StageHParams(**HP))
    buffers = {n: b.clone() for n, b in tmodel.named_buffers()}
    for i in range(2):
        img, label, _, _ = _batches(10 + i)
        key = jax.random.key(i)
        jstate = jstep(jstate, {"image": jnp.asarray(img),
                                "label": jnp.asarray(label)}, key)
        draws = jax_aug_draws(jax.random.split(key)[0], 2, (HW, HW),
                              (CROP, CROP))
        step(state, {"image": torch.from_numpy(img),
                     "label": torch.from_numpy(label)}, 0, index=i, draws=draws)
    assert all(torch.equal(b, buffers[n]) for n, b in tmodel.named_buffers())
    want_cnt = np.asarray(jstate.aligner.data_cnt)
    np.testing.assert_array_equal(state.aligner.data_cnt.numpy(), want_cnt)
    assert want_cnt.sum() > 0
    for got, want in ((state.aligner.data_sum, jstate.aligner.data_sum),
                      (init_avg(state.aligner).prototypes,
                       jax_init_avg(jstate.aligner).prototypes)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_three_align_steps_match_jax(monkeypatch):
    """Three make_align_step steps (CORAL, refine 'all' with the superpixel
    view, PCL on both domains) from the same weights, prototypes, batches
    and augmentation draws, dropout off on both sides: resnet18, 72^2 uint8
    tiles cropped to 64^2, batch 2, f32. The lowered cutoffs leave 2-5 of
    the 32 downscaled target cells labelled, so the target's PCL term
    takes part.

    Tolerances, as the stage-1 step test (tests/test_torch_train_step.py)
    and for the same reason -- the tiny model's gradients are
    ill-conditioned in f32: losses 1e-4 relative (measured 3.3e-5 at step
    3); after step 3 the parameter updates as a whole within 0.15 relative
    norm (measured 0.030) and the running statistics within 1e-2 of their
    largest entry. The prototypes move by 0.004 of the source's class means
    each step and stay within 1e-5 of the JAX package's, relative to their
    largest entry (measured 6e-6). The peak learning rate is 1e-3, not the
    stage-1 test's 1e-2: the next gradient amplifies each update's small
    f32 difference, and at 1e-2 the losses at step 3 differ by 2.4e-4; at
    1e-3 the updates after step 3 differ by 0.030."""
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", CROP, seed=1)
    proto = np.random.default_rng(3).normal(size=(C, K)).astype(np.float32)
    jstate, state = _states(variables, tmodel, prototypes=proto)
    jstep = jax_make_align_step(jmodel, JaxHParams(**HP))
    step = make_align_step(tmodel, StageHParams(**HP))
    align = []
    for i in range(3):
        img, label, tgt, sup = _batches(i)
        key = jax.random.key(i)
        jstate, jm = jstep(
            jstate, {"image": jnp.asarray(img), "label": jnp.asarray(label)},
            {"image": jnp.asarray(tgt), "sup": jnp.asarray(sup)}, key)
        k_aug_s, k_aug_t = jax.random.split(key, 4)[:2]
        draws = StepDraws(jax_aug_draws(k_aug_s, 2, (HW, HW), (CROP, CROP)),
                          jax_aug_draws(k_aug_t, 2, (HW, HW), (CROP, CROP)))
        tm = step(state, {"image": torch.from_numpy(img),
                          "label": torch.from_numpy(label)},
                  {"image": torch.from_numpy(tgt), "sup": torch.from_numpy(sup)},
                  0, draws=draws)
        for k in ("loss", "loss_seg", "loss_align", "loss_domain"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        align.append(float(tm["loss_align"]))
    assert state.step == int(jstate.step) == 3
    assert min(align) > 0
    want = np.asarray(jstate.aligner.prototypes)
    got = state.aligner.prototypes.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.abs(got - proto).max() > 1e-3        # the EMA really moved
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jstate.params),
                                "batch_stats": jax.tree.map(np.asarray,
                                                            jstate.batch_stats)})
    got = tmodel.state_dict()
    start = state_dict_from_jax(variables)
    num = den = 0.0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w, w0 = (t.double().numpy() for t in (got[k], v, start[k]))
        if "running" in k:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), k
        else:
            num += np.sum((g - w) ** 2)
            den += np.sum((w - w0) ** 2)
    assert np.sqrt(num / den) < 0.15, np.sqrt(num / den)


@pytest.mark.parametrize("mode", ["oneof", "compose"])
def test_superpixel_maps_load_and_augment_as_jax(tmp_path, mode):
    """The port writes the JAX package's superpixel maps (grid + boundary
    ring, uint16 .tif under ``<split>_sup_shrink``), finds them by the same
    path rule and reads the same ids; augmentation crops and turns them
    with the image and the label, exactly as ``augment_batch`` does from
    the same key."""
    from uemda_tpu.datasets.augment import augment_batch as jax_augment_batch
    from uemda_tpu.datasets.base import SegDataset as JaxSegDataset
    from uemda_tpu.datasets.synthetic import make_synthetic_dataset as jax_make
    from uemda_tpu_torch.datasets.augment import augment_batch
    from uemda_tpu_torch.datasets.base import SegDataset

    jimg, jann = jax_make(str(tmp_path / "jax"), IsprsDA, n_train=3, n_val=1,
                          hw=48, seed=4)
    timg, _ = make_synthetic_dataset(str(tmp_path / "port"), IsprsDA,
                                     n_train=3, n_val=1, hw=48, seed=4)
    want = JaxSegDataset(IsprsDA, [jimg], jann, read_sup=True).batch([0, 1, 2])
    got = SegDataset(IsprsDA, [jimg], jann, read_sup=True).batch([0, 1, 2])
    mine = SegDataset(IsprsDA, [timg], None, read_sup=True).batch([0, 1, 2])
    for k in ("image", "label", "sup"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(mine["sup"], want["sup"])
    np.testing.assert_array_equal(want["sup"][0], grid_superpixels(48))
    key = jax.random.key(7)
    jout = jax_augment_batch(key, {k: jnp.asarray(v) for k, v in want.items()},
                             (32, 32), (0.0,) * 3, (1.0,) * 3, mode)
    draws = jax_aug_draws(key, 3, (48, 48), (32, 32), mode)
    tout = augment_batch({k: torch.from_numpy(v) for k, v in got.items()},
                         (32, 32), (0.0,) * 3, (1.0,) * 3, draws)
    for k in ("label", "sup"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)


def _tiny_config(tmp_path):
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), IsprsDA, n_train=4, n_val=1, hw=80, seed=3)
    img, ann = root / "img_dir", root / "ann_dir"
    assert (ann / "train_sup_shrink" / "tile_000.tif").exists()
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from uemda_tpu_torch.config import PRESETS, SplitConfig\n"
        "m, s = (120.0, 82.0, 81.0), (55.0, 39.0, 38.0)\n"
        f"tr = SplitConfig(({str(img / 'train')!r},), ({str(ann / 'train')!r},), m, s, batch_size=2)\n"
        f"va = SplitConfig(({str(img / 'val')!r},), ({str(ann / 'val')!r},), m, s, batch_size=1)\n"
        "CONFIG = dataclasses.replace(PRESETS['2vaihingen'], model='resnet18', "
        f"crop=(64, 64), source=tr, target=tr, val=va, test=va, "
        f"snapshot_dir={str(tmp_path / 'log')!r})\n")
    return cfg_file


def test_stage2_clis_on_the_cpu(tmp_path):
    """train_src (1 step) -> init_prototypes (.pth) -> train_align_uem (2
    steps, CORAL, refine 'all' reading the .tif superpixel maps and the
    prototypes from a .npy copy) with --device cpu: finite prototypes over
    every full batch, an evaluation, and the best model and prototypes
    saved under <snapshot>/align, with best.json and the state snapshot;
    ``--steps 3 --resume auto`` goes on from step 2 and ends at step 3;
    a fresh ``--ls OhemCrossEntropy --accum-steps 2`` run of 2 micro-steps
    makes one update."""
    from uemda_tpu_torch.models.port import load_prototypes
    from uemda_tpu_torch.tools import init_prototypes, train_align_uem, train_src

    cfg_file = str(_tiny_config(tmp_path))
    train_src.main(["--config-path", cfg_file, "--steps", "1", "--device", "cpu"])
    ckpt = str(tmp_path / "log" / "src" / "Vaihingen_best.pth")
    proto = str(tmp_path / "log" / "src" / "prototypes.pth")
    aligner = init_prototypes.main(["--config-path", cfg_file, "--ckpt-model",
                                    ckpt, "--ckpt-proto", proto, "--device",
                                    "cpu"])
    assert float(aligner.data_cnt.sum()) > 0
    p = load_prototypes(proto)
    assert p.shape == (6, 512) and torch.isfinite(p).all()
    assert torch.equal(p, aligner.prototypes)
    proto_npy = str(tmp_path / "prototypes.npy")
    np.save(proto_npy, p.numpy())
    assert torch.equal(load_prototypes(proto_npy), p)
    common = ["--config-path", cfg_file, "--ckpt-model", ckpt, "--ckpt-proto",
              proto_npy, "--device", "cpu"]
    best = train_align_uem.main(common + ["--align-domain", "1", "--steps", "2",
                                          "--refine-mode", "all"])
    assert best["step"] == 2 and 0.0 <= best["miou"] <= 1.0
    run = tmp_path / "log" / "align"
    saved = torch.load(run / "prototypes_best.pth", weights_only=True)
    assert saved.shape == (6, 512) and not torch.equal(saved, p)
    assert (run / "Vaihingen_best.pth").exists()
    assert json.loads((run / "best.json").read_text())["step"] == 2
    assert torch.load(run / "state_curr.pth", weights_only=True)["step"] == 2
    train_align_uem.main(common + ["--align-domain", "1", "--steps", "3",
                                   "--refine-mode", "all", "--resume", "auto"])
    assert torch.load(run / "state_curr.pth", weights_only=True)["step"] == 3
    # OHEM and accumulation (once refused): two micro-steps, one update
    train_align_uem.main(common + ["--align-domain", "1", "--steps", "2",
                                   "--refine-mode", "all", "--ls",
                                   "OhemCrossEntropy", "--accum-steps", "2"])
    snap = torch.load(run / "state_curr.pth", weights_only=True)
    assert (snap["step"], snap["opt"]["count"], snap["opt"]["mini_step"]) \
        == (2, 1, 0)
    shutil.rmtree(tmp_path / "log")  # ~1 GB of checkpoints


def test_stage2_hparams_match_jax():
    """``default_hparams`` carries the JAX package's cutoffs and superpixel
    bound for every preset: 4128 for LoveDA's 1024^2 tiles, 1056 for 512^2
    ISPRS tiles."""
    from uemda_tpu import config as jax_config
    from uemda_tpu.train.loop import default_hparams as jax_default_hparams
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.train.loop import default_hparams

    fields = ("cutoff_top", "cutoff_low", "max_segments", "refine",
              "refine_mode", "refine_temp", "pcl_temp", "scale_factor")
    for name in jax_config.PRESETS:
        got = default_hparams(load_config(name))
        want = jax_default_hparams(jax_config.load_config(name))
        assert {f: getattr(got, f) for f in fields} == \
            {f: getattr(want, f) for f in fields}, name
    assert default_hparams(PRESETS["2urban"]).max_segments == 4128
    assert default_hparams(PRESETS["2vaihingen"]).max_segments == 1056

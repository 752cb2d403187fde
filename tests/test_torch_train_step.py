"""The stage-1 step on the CPU against the JAX package: the learning-rate
schedule, one optimizer update against the optax chain, three
``make_src_step`` steps with CORAL, and the ``train_src`` twin end to end
with its checkpoint read back by the eval tool."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from tests.torch_port_helpers import jax_and_torch_models, jax_aug_draws
from uemda_tpu.train.lr import poly_warmup_schedule as jax_schedule
from uemda_tpu.train.optim import freeze_mask as jax_freeze_mask
from uemda_tpu.train.optim import make_optimizer
from uemda_tpu.train.state import create_train_state
from uemda_tpu.train.steps import StageHParams as JaxHParams
from uemda_tpu.train.steps import make_src_step as jax_make_src_step
from uemda_tpu_torch.config import PRESETS, load_config
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset
from uemda_tpu_torch.models import heads as torch_heads
from uemda_tpu_torch.models.port import state_dict_from_jax
from uemda_tpu_torch.train.loop import build_state
from uemda_tpu_torch.train.lr import poly_warmup_schedule
from uemda_tpu_torch.train.optim import SGD, freeze_mask
from uemda_tpu_torch.train.steps import StageHParams, StepDraws, make_src_step

C, HW, CROP = 6, 72, 64


@pytest.mark.parametrize("stop", [30, 4000])
def test_lr_schedule_matches_jax(stop):
    """Warm-up to stop/20, then poly 0.9 over 1.5 x stop; rtol 1e-6
    (test_optim_lr.py:25). lr(0) = 0."""
    ours, theirs = poly_warmup_schedule(1e-2, stop), jax_schedule(1e-2, stop)
    assert ours(0) == 0.0
    for it in sorted({0, 1, 2, stop // 20 - 1, stop // 20, stop // 2, stop - 1}):
        np.testing.assert_allclose(ours(it), float(theirs(it)), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 40.0], ids=["unclipped", "clipped"])
def test_sgd_update_matches_optax(scale):
    """Three updates of the port's SGD against the optax chain (clip 32 ->
    weight decay 5e-4 -> momentum 0.9 -> -lr(count), then the freeze mask)
    on the same parameters and gradients, with the clip inactive and
    active; the frozen stem's gradient counts in the norm. rtol 1e-6."""
    r = np.random.default_rng(0)
    shapes = {"encoder.resnet.conv1.weight": (4, 3), "encoder.resnet.layer1.0"
              ".conv1.weight": (5,), "layer5.conv_last.4.bias": (6,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    sched = lambda step: 0.01 * (step + 1)

    def nest(flat):  # dotted names -> the flax-like tree freeze_mask reads
        tree = {}
        for k, v in flat.items():
            parts = k.split(".")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return tree

    jparams = nest({k: jnp.asarray(v) for k, v in p0.items()})
    # the JAX mask is computed on the flax layout (encoder.<stage>); carry it
    # over to the dotted layout of this test
    mask = jax_freeze_mask({"encoder": jparams["encoder"]["resnet"],
                            "layer5": jparams["layer5"]}, 1)
    mask = {"encoder": {"resnet": mask["encoder"]}, "layer5": mask["layer5"]}
    tx = make_optimizer(sched, trainable_mask=mask)
    state = tx.init(jparams)
    for g in grads:
        upd, state = tx.update(nest({k: jnp.asarray(v) for k, v in g.items()}),
                               state, jparams)
        jparams = optax.apply_updates(jparams, upd)

    tparams = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    named = list(tparams.items())
    opt = SGD(named, sched, trainable=freeze_mask(named, 1))
    assert opt.trainable == [False, True, True]
    norms = []
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(opt.step()))
    assert (min(norms) >= 32.0) == (scale > 1)
    flat = {"encoder.resnet.conv1.weight": jparams["encoder"]["resnet"]["conv1"]["weight"],
            "encoder.resnet.layer1.0.conv1.weight":
                jparams["encoder"]["resnet"]["layer1"]["0"]["conv1"]["weight"],
            "layer5.conv_last.4.bias": jparams["layer5"]["conv_last"]["4"]["bias"]}
    for k, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(flat[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tparams["encoder.resnet.conv1.weight"].numpy(),
                                  p0["encoder.resnet.conv1.weight"])
    with pytest.raises(NotImplementedError):
        SGD(named, sched, accum_steps=2)


def _batches(seed, b=2):
    r = np.random.default_rng(seed)
    label = np.kron(r.integers(0, C, (b, HW // 8, HW // 8)),
                    np.ones((8, 8), np.int64)).astype(np.int32)
    label[:, :4] = -1
    palette = np.linspace(40, 215, C)[:, None] * np.array([[1.0, 0.8, 0.6]])
    img = np.clip(palette[label.clip(0)] + r.normal(0, 8, label.shape + (3,)),
                  0, 255).astype(np.uint8)
    tgt = np.clip(img[::-1].astype(np.float32) + 20, 0, 255).astype(np.uint8)
    return img, label, tgt


def test_three_src_steps_match_jax(monkeypatch):
    """Three make_src_step steps with CORAL on, from the same weights,
    batches and augmentation draws (derived from the JAX step's keys), with
    dropout patched out on both sides as test_ref_golden_model.py:115-117
    does: resnet18, 72^2 uint8 tiles cropped to 64^2, batch 2, f32.

    Tolerances. The per-step losses agree to 1e-4 rel (measured 4e-5 at
    step 3). The gradients of this tiny model are ill-conditioned at f32:
    its PPM 1x1-pool BatchNorm sees two values per channel and instance
    norm 16 pixels, and scaling the weights by 1 + 1e-7 noise moves the
    port's own first gradient by 3.4e-3 of its largest entry -- as much as
    the two frameworks differ there. So after step 3 the parameter updates
    are held as a whole, ||dp_port - dp_jax|| / ||dp_jax|| < 0.15 (measured
    0.062), and the running statistics per tensor to 1e-2 of their largest
    entry (measured 1.6e-3). A wrong schedule, momentum or running-variance
    rule misses these by far; the optimizer's exact arithmetic is
    test_sgd_update_matches_optax's."""
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", CROP, seed=1)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(torch_heads.Dropout, "forward",
                        lambda self, x, generator=None, mask=None: x)
    norm = dict(src_mean=(128.0,) * 3, src_std=(64.0,) * 3,
                tgt_mean=(120.0,) * 3, tgt_std=(60.0,) * 3)
    jhp = JaxHParams(class_num=C, crop=(CROP, CROP), align_domain=True,
                     compute_dtype="float32", **norm)
    jstate = create_train_state(
        jax.tree.map(jnp.asarray, variables),
        make_optimizer(jax_schedule(1e-2, 40)), C, feat_channels=512)
    jstep = jax_make_src_step(jmodel, jhp)

    hp = StageHParams(class_num=C, crop=(CROP, CROP), align_domain=True,
                      compute_dtype="float32", **norm)
    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18")
    state = build_state(tmodel, dataclasses.replace(cfg, learning_rate=1e-2), 40)
    step = make_src_step(tmodel, hp)
    for i in range(3):
        img, label, tgt = _batches(i)
        key = jax.random.key(i)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(img),
                                    "label": jnp.asarray(label)},
                           {"image": jnp.asarray(tgt)}, key)
        k_aug_s, k_aug_t = jax.random.split(key, 5)[:2]
        draws = StepDraws(jax_aug_draws(k_aug_s, 2, (HW, HW), (CROP, CROP)),
                          jax_aug_draws(k_aug_t, 2, (HW, HW), (CROP, CROP)))
        tm = step(state, {"image": torch.from_numpy(img),
                          "label": torch.from_numpy(label)},
                  {"image": torch.from_numpy(tgt)}, 0, draws=draws)
        for k in ("loss", "loss_seg", "loss_domain"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert state.step == int(jstate.step) == 3
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jstate.params),
                                "batch_stats": jax.tree.map(np.asarray,
                                                            jstate.batch_stats)})
    got = tmodel.state_dict()
    start = state_dict_from_jax(variables)
    num = den = 0.0
    moved = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w, w0 = (t.double().numpy() for t in (got[k], v, start[k]))
        moved += int(not np.array_equal(w, w0))
        if "running" in k:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), k
        else:
            num += np.sum((g - w) ** 2)
            den += np.sum((w - w0) ** 2)
    assert np.sqrt(num / den) < 0.15, np.sqrt(num / den)
    assert moved > 100  # the updates and statistics really moved


def test_train_src_twin_on_the_cpu(tmp_path, capsys):
    """python -m uemda_tpu_torch.tools.train_src --steps 3 --device cpu on a
    tiny synthetic config (resnet18, 64^2 crops of 72^2 tiles, CORAL on):
    three finite steps, an evaluation, and a best checkpoint that the eval
    tool loads."""
    from uemda_tpu_torch.tools import eval as eval_cli
    from uemda_tpu_torch.tools import train_src

    root = tmp_path / "data"
    make_synthetic_dataset(str(root), IsprsDA, n_train=4, n_val=1, hw=HW, seed=3)
    img, ann = root / "img_dir", root / "ann_dir"
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
    best = train_src.main(["--config-path", str(cfg_file), "--align-domain", "1",
                           "--steps", "3", "--device", "cpu"])
    assert best["step"] == 3 and 0.0 <= best["miou"] <= 1.0
    ckpt = tmp_path / "log" / "src" / "Vaihingen_best.pth"
    assert ckpt.exists()
    capsys.readouterr()
    eval_cli.main(["--config-path", str(cfg_file), "--ckpt-path", str(ckpt),
                   "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(out["miou"], best["miou"], atol=1e-6)
    cfg = load_config(str(cfg_file), snapshot_postfix="/src")
    assert cfg.snapshot_dir.endswith("log/src")


def test_config_training_fields_match_jax():
    """Every preset carries the JAX package's training fields: snapshot
    directory (and the stage postfix), schedule, optimizer, cutoffs, crop,
    target clamp."""
    from uemda_tpu import config as jax_config

    fields = ("snapshot_dir", "model", "learning_rate", "momentum",
              "weight_decay", "power", "stage1_steps", "stage2_steps",
              "stage3_steps", "eval_every", "gene_every", "cutoff_top",
              "cutoff_low", "crop", "clamp_target", "ignore_label",
              "class_num")
    for name in list(jax_config.PRESETS) + ["st.proca.2urban"]:
        got = load_config(name, snapshot_postfix="/src")
        want = jax_config.load_config(name, snapshot_postfix="/src")
        assert {f: getattr(got, f) for f in fields} == \
            {f: getattr(want, f) for f in fields}, name
        for split in ("source", "target"):
            g, w = getattr(got, split), getattr(want, split)
            assert (g.image_dir, g.mask_dir, g.mean, g.std, g.batch_size) == \
                (w.image_dir, w.mask_dir, w.mean, w.std, w.batch_size)

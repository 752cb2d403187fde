"""The stage-3 step of the port on the CPU against the JAX package: three
``make_ssl_step`` steps (UVEM target loss, refine 'all', target class
balance, the ISPRS clamp) and one stage-1 step with source class balance.
The stage-3 and pipeline CLIs are ``test_torch_pipeline.py``'s."""

import dataclasses

import numpy as np
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, jax_aug_draws
from uemda_tpu.train.lr import poly_warmup_schedule as jax_schedule
from uemda_tpu.train.optim import make_optimizer
from uemda_tpu.train.state import create_train_state
from uemda_tpu.train.steps import StageHParams as JaxHParams
from uemda_tpu.train.steps import make_src_step as jax_make_src_step
from uemda_tpu.train.steps import make_ssl_step as jax_make_ssl_step
from uemda_tpu_torch.config import PRESETS
from uemda_tpu_torch.datasets.synthetic import grid_superpixels
from uemda_tpu_torch.models import heads as torch_heads
from uemda_tpu_torch.models.port import state_dict_from_jax
from uemda_tpu_torch.train.loop import build_state
from uemda_tpu_torch.train.steps import (
    StageHParams,
    StepDraws,
    make_src_step,
    make_ssl_step,
)

C, HW, CROP, K = 6, 72, 64, 512
LR = 1e-3
NORM = dict(src_mean=(128.0,) * 3, src_std=(64.0,) * 3,
            tgt_mean=(120.0,) * 3, tgt_std=(60.0,) * 3)
HP = dict(class_num=C, crop=(CROP, CROP), compute_dtype="float32",
          refine=True, refine_mode="all", target_loss="uvem",
          balance_target=True, clamp_target=True, max_segments=64, **NORM)


def _batches(seed, b=2):
    """Source tiles with blocky labels; target tiles with grid superpixels
    and stored soft labels (fp16, as the sweep writes them) whose
    confidence varies by 8-pixel block, so after refinement some pixels
    are selected, some trained (u <= t) at a weight strictly between 0 and
    1, and the target loss is not zero."""
    r = np.random.default_rng(seed)
    label = np.kron(r.integers(0, C, (b, 3, 3)),
                    np.ones((32, 32), np.int64))[:, :HW, :HW].astype(np.int32)
    label[:, :4] = -1
    palette = np.linspace(40, 215, C)[:, None] * np.array([[1.0, 0.8, 0.6]])
    img = np.clip(palette[label.clip(0)] + r.normal(0, 8, label.shape + (3,)),
                  0, 255).astype(np.uint8)
    tgt = np.clip(img[::-1].astype(np.float32) + 20, 0, 255).astype(np.uint8)
    sup = np.stack([np.roll(grid_superpixels(80), (i * 5, i * 3), (0, 1))[:HW, :HW]
                    for i in range(b)]).astype(np.int32)
    scale = np.kron(r.choice([1.0, 3.0, 6.0, 12.0], (b, 9, 9)),
                    np.ones((8, 8)))[..., None]
    logit = r.normal(size=(b, HW, HW, C)) * scale
    prob = np.exp(logit - logit.max(-1, keepdims=True))
    prob = (prob / prob.sum(-1, keepdims=True)).astype(np.float16)
    return img, label, tgt, sup, prob


def _no_dropout(monkeypatch):
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


def _updates_close(tmodel, jstate, variables):
    """After the steps, the parameter updates as a whole within 0.15
    relative norm of JAX's and the running statistics within 1e-2 of their
    largest entry (the stage-1 and stage-2 step tests' limits, for the same
    ill-conditioning of the tiny model in f32)."""
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


def test_three_ssl_steps_match_jax(monkeypatch):
    """Three make_ssl_step steps from the same weights, prototypes, batches
    and augmentation draws (source "oneof", target "compose" with the
    clamp), dropout off on both sides: resnet18, 72^2 uint8 tiles cropped
    to 64^2, batch 2, f32, UVEM with refine 'all' (the superpixel view) and
    the target class balance. The losses 1e-4 relative; the prototypes'
    EMA within 1e-5 of their largest entry; the class-balance frequencies
    within 1e-6; the updates and statistics as ``_updates_close``. The
    stored soft labels leave pixels selected and trained at every step,
    and the target loss is not zero."""
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", CROP, seed=1)
    proto = np.random.default_rng(3).normal(size=(C, K)).astype(np.float32)
    jstate, state = _states(variables, tmodel, prototypes=proto)
    jstep = jax_make_ssl_step(jmodel, JaxHParams(**HP))
    step = make_ssl_step(tmodel, StageHParams(**HP))
    for i in range(3):
        img, label, tgt, sup, prob = _batches(i)
        key = jax.random.key(i)
        jstate, jm = jstep(
            jstate, {"image": jnp.asarray(img), "label": jnp.asarray(label)},
            {"image": jnp.asarray(tgt), "sup": jnp.asarray(sup),
             "prob": jnp.asarray(prob.astype(np.float32))}, key)
        k_aug_s, k_aug_t = jax.random.split(key, 4)[:2]
        draws = StepDraws(
            jax_aug_draws(k_aug_s, 2, (HW, HW), (CROP, CROP)),
            jax_aug_draws(k_aug_t, 2, (HW, HW), (CROP, CROP), "compose"))
        tm = step(state, {"image": torch.from_numpy(img),
                          "label": torch.from_numpy(label)},
                  {"image": torch.from_numpy(tgt), "sup": torch.from_numpy(sup),
                   "prob": torch.from_numpy(prob)}, 0, draws=draws)
        for k in ("loss", "loss_source", "loss_target"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        assert float(tm["loss_target"]) > 0.01
        assert 0 < float(tm["selected"]) < 1 and 0 < float(tm["trained"]) < 1
        assert 0 < float(tm["w_mean"]) < 1
        np.testing.assert_allclose(state.balance_t.freq.numpy(),
                                   np.asarray(jstate.balance_t.freq),
                                   rtol=1e-6)
    assert state.step == int(jstate.step) == 3
    assert not np.allclose(state.balance_t.freq.numpy(), 1.0 / C)
    want = np.asarray(jstate.aligner.prototypes)
    got = state.aligner.prototypes.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.abs(got - proto).max() > 1e-3        # the EMA really moved
    _updates_close(tmodel, jstate, variables)


def test_src_step_with_class_balance_matches_jax(monkeypatch):
    """One stage-1 step with ``balance_source`` (CORAL on): the CE of every
    pixel weighted by the source class balance, whose EMA moves first. The
    losses 1e-4 relative and the frequencies 1e-6 of JAX's; the weighted
    loss differs from the unweighted one."""
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", CROP, seed=2)
    jstate, state = _states(variables, tmodel)
    hp = dict(class_num=C, crop=(CROP, CROP), align_domain=True,
              balance_source=True, compute_dtype="float32", **NORM)
    img, label, tgt, _, _ = _batches(7)
    key = jax.random.key(5)
    jstate, jm = jax_make_src_step(jmodel, JaxHParams(**hp))(
        jstate, {"image": jnp.asarray(img), "label": jnp.asarray(label)},
        {"image": jnp.asarray(tgt)}, key)
    k_aug_s, k_aug_t = jax.random.split(key, 5)[:2]
    draws = StepDraws(jax_aug_draws(k_aug_s, 2, (HW, HW), (CROP, CROP)),
                      jax_aug_draws(k_aug_t, 2, (HW, HW), (CROP, CROP)))
    batches = ({"image": torch.from_numpy(img), "label": torch.from_numpy(label)},
               {"image": torch.from_numpy(tgt)})
    tm = make_src_step(tmodel, StageHParams(**hp))(state, *batches, 0,
                                                   draws=draws)
    for k in ("loss", "loss_seg", "loss_domain"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(state.balance_s.freq.numpy(),
                               np.asarray(jstate.balance_s.freq), rtol=1e-6)
    assert not np.allclose(state.balance_s.freq.numpy(), 1.0 / C)
    plain = dict(hp, balance_source=False)
    _, jm0 = jax_make_src_step(jmodel, JaxHParams(**plain))(
        _states(variables, tmodel)[0],
        {"image": jnp.asarray(img), "label": jnp.asarray(label)},
        {"image": jnp.asarray(tgt)}, key)
    assert abs(float(jm0["loss_seg"]) - float(tm["loss_seg"])) > 1e-3

"""The stage-3 steps of the loss zoo on the CPU against the JAX package's
``make_ssl_step``: the OHEM source loss with the GHM target loss (and its
histogram state), and the UPS target loss, each with the target class
balance on. Accumulation and PROCA's stage 2 are
``test_torch_accum_steps.py``'s."""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tests.torch_port_helpers import jax_aug_draws, models_from_port
from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from uemda_tpu.train.lr import poly_warmup_schedule as jax_schedule
from uemda_tpu.train.optim import make_optimizer
from uemda_tpu.train.state import create_train_state
from uemda_tpu.train.steps import StageHParams as JaxHParams
from uemda_tpu.train.steps import make_ssl_step as jax_make_ssl_step
from uemda_tpu_torch.config import PRESETS
from uemda_tpu_torch.models import heads as torch_heads
from uemda_tpu_torch.models.port import state_dict_from_jax
from uemda_tpu_torch.train.loop import build_state
from uemda_tpu_torch.train.steps import StageHParams, StepDraws, make_ssl_step

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

C, HW, CROP, K = 6, 72, 64, 512
LR = 1e-3
NORM = dict(src_mean=(128.0,) * 3, src_std=(64.0,) * 3,
            tgt_mean=(120.0,) * 3, tgt_std=(60.0,) * 3)


def _batches(seed, b=2):
    """Source tiles with 32-pixel class blocks (some rows ignored); target
    tiles; stored fp16 soft labels whose confidence varies by 8-pixel
    block (``test_torch_ssl_step.py``'s)."""
    r = np.random.default_rng(seed)
    label = np.kron(r.integers(0, C, (b, 3, 3)),
                    np.ones((32, 32), np.int64))[:, :HW, :HW].astype(np.int32)
    label[:, :4] = -1
    palette = np.linspace(40, 215, C)[:, None] * np.array([[1.0, 0.8, 0.6]])
    img = np.clip(palette[label.clip(0)] + r.normal(0, 8, label.shape + (3,)),
                  0, 255).astype(np.uint8)
    tgt = np.clip(img[::-1].astype(np.float32) + 20, 0, 255).astype(np.uint8)
    scale = np.kron(r.choice([1.0, 3.0, 6.0, 12.0], (b, 9, 9)),
                    np.ones((8, 8)))[..., None]
    logit = r.normal(size=(b, HW, HW, C)) * scale
    prob = np.exp(logit - logit.max(-1, keepdims=True))
    prob = (prob / prob.sum(-1, keepdims=True)).astype(np.float16)
    return img, label, tgt, prob


def _no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(torch_heads.Dropout, "forward",
                        lambda self, x, generator=None, mask=None: x)


def _states(variables, tmodel, prototypes=None, stop=40, accum=1):
    jstate = create_train_state(
        jax.tree.map(jnp.asarray, variables),
        make_optimizer(jax_schedule(LR, -(-stop // accum)), accum_steps=accum),
        C, feat_channels=K,
        prototypes=None if prototypes is None else jnp.asarray(prototypes))
    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                              learning_rate=LR)
    state = build_state(tmodel, cfg, stop, prototypes=prototypes,
                        feat_channels=K, accum_steps=accum)
    return jstate, state


def _jax_sd(jstate):
    return state_dict_from_jax({"params": jax.tree.map(np.asarray, jstate.params),
                                "batch_stats": jax.tree.map(np.asarray,
                                                            jstate.batch_stats)})


def _updates_close(tmodel, jstate, variables, limit=0.15):
    """The parameter updates as a whole within ``limit`` relative norm of
    JAX's and the running statistics within 1e-2 of their largest entry
    (the stage-step tests' limits, for the tiny model's ill-conditioned
    f32 gradients: ``test_torch_train_step.py``)."""
    want, got, start = _jax_sd(jstate), tmodel.state_dict(), \
        state_dict_from_jax(variables)
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
    assert den > 0 and np.sqrt(num / den) < limit, np.sqrt(num / den)


def _step_pair(jstep, step, jstate, state, seed, target, n_split, mode):
    """One step of each on ``_batches(seed)`` with the JAX step's draws;
    returns (jstate, JAX metrics, port metrics)."""
    img, label, tgt, prob = _batches(seed)
    key = jax.random.key(seed)
    bt = {"image": tgt}
    if target == "prob":
        bt["prob"] = prob
    jstate, jm = jstep(
        jstate, {"image": jnp.asarray(img), "label": jnp.asarray(label)},
        {k: jnp.asarray(v.astype(np.float32) if k == "prob" else v)
         for k, v in bt.items()}, key)
    k_aug_s, k_aug_t = jax.random.split(key, n_split)[:2]
    draws = StepDraws(jax_aug_draws(k_aug_s, 2, (HW, HW), (CROP, CROP)),
                      jax_aug_draws(k_aug_t, 2, (HW, HW), (CROP, CROP), mode))
    tm = step(state, {"image": torch.from_numpy(img),
                      "label": torch.from_numpy(label)},
              {k: torch.from_numpy(v) for k, v in bt.items()}, 0, draws=draws)
    return jstate, jm, tm


@pytest.mark.parametrize("source_loss,loss", [("ohem", "ghm"), ("ce", "ups")])
def test_ssl_steps_with_the_zoo_match_jax(source_loss, loss, monkeypatch):
    """Two stage-3 steps (no refinement, the target class balance on)
    against ``make_ssl_step``, f32, dropout off: the OHEM source loss with
    the GHM target loss, and CE with the UPS target loss. The losses 1e-4
    relative. GHM: ``acc_sum`` (both heads, two steps) holds the same
    number of pixels (1e-5 relative) and each bin is within 1.01e-2 of
    JAX's (one pixel's weight, 1 - momentum: a gradient norm the two
    frameworks round either side of an edge lands in the next bin), and
    the target class balance stays untouched, as JAX gates it. UPS moves
    the balance as JAX's (1e-6) and leaves the histogram at 0. The updates
    as ``_updates_close``."""
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = models_from_port("resnet18", seed=2)
    proto = np.random.default_rng(3).normal(size=(C, K)).astype(np.float32)
    jstate, state = _states(variables, tmodel, prototypes=proto)
    hp = dict(class_num=C, crop=(CROP, CROP), compute_dtype="float32",
              refine=False, source_loss=source_loss, target_loss=loss,
              balance_target=True, clamp_target=True, **NORM)
    jstep = jax_make_ssl_step(jmodel, JaxHParams(**hp))
    step = make_ssl_step(tmodel, StageHParams(**hp))
    for i in range(2):
        jstate, jm, tm = _step_pair(jstep, step, jstate, state, 10 + i, "prob",
                                    4, "compose")
        for k in ("loss", "loss_source", "loss_target"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        assert float(tm["loss_target"]) > 0
    freq = state.balance_t.freq.numpy()
    np.testing.assert_allclose(freq, np.asarray(jstate.balance_t.freq),
                               rtol=1e-6)
    acc = state.ghm.acc_sum.numpy()
    if loss == "ghm":
        want = np.asarray(jstate.ghm.acc_sum)
        np.testing.assert_allclose(acc, want, rtol=0, atol=1.01e-2)
        np.testing.assert_allclose(acc.sum(), want.sum(), rtol=1e-5)
        assert want.sum() > 0
        np.testing.assert_array_equal(freq, np.full(C, 1.0 / C, np.float32))
    else:
        assert not np.allclose(freq, 1.0 / C)
        assert float(np.abs(acc).max()) == 0
    _updates_close(tmodel, jstate, variables)


"""The stage-1 slice's model and losses on the CPU against the JAX package:
the PPM dropout (elementwise, as flax's; the torch reference's
``Dropout2d`` zeroes whole channels), the train-mode forward
``(x1, x2, feat)`` and the BatchNorm running statistics it writes, with the
JAX dropout masks fed to the port, and CE, ``loss_calc`` and CORAL."""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, to_nhwc, to_torch
from uemda_tpu.alignment.coral import align_domain as jax_align_domain
from uemda_tpu.alignment.losses import cross_entropy_loss as jax_ce
from uemda_tpu.alignment.losses import loss_calc as jax_loss_calc
from uemda_tpu_torch.alignment.coral import align_domain, coral_loss
from uemda_tpu_torch.alignment.losses import cross_entropy_loss, loss_calc
from uemda_tpu_torch.models.config import PPMConfig
from uemda_tpu_torch.models.heads import Dropout, PPMBilinear
from uemda_tpu_torch.models.port import state_dict_from_jax

HW = 64


def _zero_pattern(module_or_fn, shape=(2, 8, 16, 16)):
    """The keep pattern of one train-mode dropout draw over ones."""
    x = torch.ones(shape)
    if isinstance(module_or_fn, torch.nn.Module):
        module_or_fn.train()
        y = module_or_fn(x)
    else:
        y = module_or_fn(x)
    return (y != 0).float()


def _channelwise(keep):
    """True when every (sample, channel) is kept or dropped as a whole."""
    per = keep.mean(dim=(2, 3))
    return bool(((per == 0) | (per == 1)).all())


def test_ppm_dropout_is_elementwise_as_flax():
    """The fault and its repair: the torch reference's nn.Dropout2d(0.1)
    drops whole channels; flax.linen.Dropout(0.1) -- the JAX head's --
    drops single elements, and so does the port's Dropout now, at rate 0.1
    and scaled by 1/0.9, drawn from the caller's generator."""
    g = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    assert _channelwise(_zero_pattern(torch.nn.Dropout2d(0.1)))

    drop = fnn.Dropout(0.1, deterministic=False)
    keep_jax = np.array(drop.apply({}, jnp.ones((2, 16, 16, 8)),
                                     rngs={"dropout": jax.random.key(0)}) != 0)
    assert not _channelwise(torch.from_numpy(keep_jax).float().permute(0, 3, 1, 2))

    # the PPM head's own dropout (conv_last.3)
    port = PPMBilinear(PPMConfig(num_classes=6, fc_dim=64)).train().conv_last[3]
    assert isinstance(port, Dropout) and port.rate == 0.1
    keep = _zero_pattern(lambda x: port(x, g))
    assert not _channelwise(keep)
    assert abs(1 - keep.mean().item() - 0.1) < 0.02
    y = port(torch.full((2, 8, 16, 16), 0.9), g)
    assert set(np.unique(y.numpy()).tolist()) <= {0.0, np.float32(0.9) / np.float32(0.9)}
    # the same generator state draws the same mask; eval mode is the identity
    a = port(torch.ones(4, 4, 4, 4), torch.Generator().manual_seed(3))
    b = port(torch.ones(4, 4, 4, 4), torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert torch.equal(port.eval()(torch.ones(2, 2, 2, 2)), torch.ones(2, 2, 2, 2))


def _record_dropout_masks(monkeypatch):
    """Intercept flax's Dropout draw (jax.random.bernoulli in
    flax/linen/stochastic.py) and keep every keep-mask, in call order."""
    masks = []
    orig = jax.random.bernoulli

    def bernoulli(key, p=0.5, shape=None, *a, **k):
        m = orig(key, p, shape, *a, **k)
        masks.append(np.asarray(m))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return masks


def test_train_forward_and_batch_stats_match_jax(monkeypatch):
    """(x1, x2, feat) of the train-mode forward and the BatchNorm running
    statistics it writes, against model.apply(train=True,
    mutable=['batch_stats']) with the JAX dropout masks fed to the port:
    resnet18, 64^2, batch 2, PPM heads (fc_dim 512), randomized BN stats,
    f32. Tolerance 1e-4: the two sides sum convolutions and batch
    statistics in different orders (flax takes E[x^2]-E[x]^2). An unbiased
    running variance fails here (2x at the PPM's 1x1 pool with batch 2), and
    so would channel-wise dropout."""
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", HW, seed=4)
    x = np.random.default_rng(5).normal(size=(2, HW, HW, 3)).astype(np.float32)
    masks = _record_dropout_masks(monkeypatch)
    (j1, j2, jfeat), mut = jmodel.apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(9)})
    assert len(masks) == 2 and masks[0].shape == (2, 4, 4, 512)
    tmodel.train()
    drop = {name: torch.from_numpy(m.copy()).permute(0, 3, 1, 2)
            for name, m in zip(("layer5", "layer6"), masks)}
    t1, t2, tfeat = tmodel(to_torch(x), dropout_masks=drop)
    for got, want in ((t1, j1), (t2, j2), (tfeat, jfeat)):
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    want_sd = state_dict_from_jax({"params": variables["params"],
                                   "batch_stats": jax.tree.map(np.asarray,
                                                               mut["batch_stats"])})
    got_sd = tmodel.state_dict()
    names = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (20 + 2 * 5)  # trunk BNs + 5 per PPM head
    for k in names:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_frozen_batchnorm_keeps_running_statistics():
    """batchnorm_trainable=False (the reference's BN-eval trick): the trunk
    normalizes with its running statistics in train mode and never updates
    them; the heads' BatchNorms still train."""
    from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config

    cfg = DeeplabV2Config.uemda_default(6, resnet_type="resnet18")
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, batchnorm_trainable=False))
    model = DeeplabV2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    model(torch.randn(2, 3, 32, 32))
    after = model.state_dict()
    assert torch.equal(after["encoder.resnet.bn1.running_mean"],
                       before["encoder.resnet.bn1.running_mean"])
    assert not torch.equal(after["layer5.conv_last.1.running_mean"],
                           before["layer5.conv_last.1.running_mean"])


def _logits_labels(seed, b=2, c=6, h=8, w=8, hl=32, wl=32):
    r = np.random.default_rng(seed)
    logits = (r.normal(size=(b, h, w, c)) * 3).astype(np.float32)
    labels = r.integers(-1, c, (b, hl, wl)).astype(np.int32)
    return logits, labels


def test_cross_entropy_matches_jax():
    """CE over all pixels, ignored ones as 0, at the label resolution and
    through loss_calc's align_corners upsampling of two heads; 1e-6 rel."""
    l1, labels = _logits_labels(0, h=32, w=32)
    want = float(jax_ce(jnp.asarray(l1), jnp.asarray(labels)))
    got = cross_entropy_loss(to_torch(l1), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    heads = [_logits_labels(s)[0] for s in (1, 2)]
    want = float(jax_loss_calc([jnp.asarray(h) for h in heads],
                               jnp.asarray(labels), jax_ce))
    got = loss_calc([to_torch(h) for h in heads], torch.from_numpy(labels),
                    cross_entropy_loss)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    # every pixel ignored: 0, not NaN
    none = cross_entropy_loss(to_torch(l1), torch.full((2, 32, 32), -1))
    assert none.item() == 0.0


def test_coral_matches_jax():
    """align_domain (flatten NHWC features, CORAL) on (2, 4, 4, 64) f32
    features; 1e-6 rel. TF32 on for matmuls raises."""
    r = np.random.default_rng(3)
    fs = r.normal(size=(2, 4, 4, 64)).astype(np.float32)
    ft = (r.normal(size=(2, 4, 4, 64)) * 1.5 + 0.3).astype(np.float32)
    want = float(jax_align_domain(jnp.asarray(fs), jnp.asarray(ft)))
    got = align_domain(to_torch(fs), to_torch(ft))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="TF32"):
            coral_loss(torch.zeros(4, 2), torch.zeros(4, 2))
    finally:
        torch.set_float32_matmul_precision(prev)

"""The alignment, model and training modules of the other DA baselines on
the CPU against the JAX package, on seeded numpy inputs in f32: the extra
losses, the discriminators and the MMD baseline model (with their weights
carried by ``models/port.py``), TransNorm, DCA, MMD, EMA, class-aware
whitening, SAW, MSC, the contrastive losses and the domain balance. Values
within 1e-5 of the largest reference entry, integer outputs exactly;
gradients where a function is used for its gradient (BCE, CCR,
TransNorm, MMD)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uemda_tpu.alignment import contrastive as j_con
from uemda_tpu.alignment import dca as j_dca
from uemda_tpu.alignment import domain_balance as j_db
from uemda_tpu.alignment import extra_losses as j_ex
from uemda_tpu.alignment import mmd as j_mmd
from uemda_tpu.alignment import msc as j_msc
from uemda_tpu.alignment import saw as j_saw
from uemda_tpu.alignment import whiten as j_wh
from uemda_tpu.models import discriminator as j_disc
from uemda_tpu.models.trans_norm import TransNorm2d as JaxTransNorm
from uemda_tpu.train import ema as j_ema
from uemda_tpu_torch.alignment import contrastive, dca, domain_balance
from uemda_tpu_torch.alignment import extra_losses as ex
from uemda_tpu_torch.alignment import mmd, msc, saw, whiten
from uemda_tpu_torch.models import discriminator as disc
from uemda_tpu_torch.models import port
from uemda_tpu_torch.models.trans_norm import TransNorm2d
from uemda_tpu_torch.train import ema

C = 6


def close(got, want, tol=1e-5):
    """|got - want| within ``tol`` of the largest |want| entry."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def jit(fn, **static):
    """``fn`` compiled by XLA once, its keyword arguments ``static`` bound:
    cheaper than the op-by-op compiles of an eager call."""
    return jax.jit(functools.partial(fn, **static))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------- extra losses


def test_extra_losses_match_jax():
    """som, entropy and KLD regularizers, BCE on logits (and its gradient),
    the robust BCE and ias_thresh."""
    r = np.random.default_rng(0)
    loss = np.abs(r.normal(size=(4, 9, 9))).astype(np.float32)
    loss[0, :3] = 0.0
    for ratio in (0.5, 0.1, 1.0):
        close(ex.som(torch.from_numpy(loss), ratio),
              j_ex.som(jnp.asarray(loss), ratio))
    logits = r.normal(size=(2, 8, 8, C)).astype(np.float32)
    weight = (r.random((2, 8, 8, 1)) * (r.random((2, 8, 8, 1)) > 0.3)) \
        .astype(np.float32)
    for t_fn, j_fn in ((ex.entropy_loss, j_ex.entropy_loss),
                       (ex.kld_loss, j_ex.kld_loss)):
        close(t_fn(nchw(logits), nchw(weight)),
              j_fn(jnp.asarray(logits), jnp.asarray(weight)))
    pred = (r.normal(size=(2, 1, 5, 5)) * 4).astype(np.float32)
    tgt = (r.random((2, 1, 5, 5)) > 0.5).astype(np.float32)
    tp = torch.from_numpy(pred).requires_grad_()
    val = ex.bce_logits_loss(tp, torch.from_numpy(tgt))
    val.backward()
    jv, jg = jax.value_and_grad(j_ex.bce_logits_loss)(jnp.asarray(pred),
                                                      jnp.asarray(tgt))
    close(val, jv)
    close(tp.grad, jg)
    prob = r.random((3, 7)).astype(np.float32)
    close(ex.robust_binary_crossentropy(torch.from_numpy(prob),
                                        torch.from_numpy(tgt.reshape(-1)[:21]
                                                         .reshape(3, 7))),
          j_ex.robust_binary_crossentropy(jnp.asarray(prob),
                                          jnp.asarray(tgt.reshape(-1)[:21]
                                                      .reshape(3, 7))))
    conf = {0: list(r.random(50)), 2: list(r.random(30)), 3: []}
    w = r.random(C)
    for kw in ({}, {"w": w, "gamma": 2.0}):
        np.testing.assert_array_equal(ex.ias_thresh(conf, C, 0.3, **kw),
                                      j_ex.ias_thresh(conf, C, 0.3, **kw))


def test_mixup_matches_jax_on_its_draws():
    """``mixup`` on the permutation and split row the JAX function derives
    from its key: bit-equal."""
    r = np.random.default_rng(1)
    s_img, t_img = (r.normal(size=(3, 10, 6, 3)).astype(np.float32)
                    for _ in range(2))
    s_lab, t_lab = (r.integers(-1, C, (3, 10, 6)).astype(np.int32)
                    for _ in range(2))
    for seed in range(3):
        key = jax.random.key(seed)
        want = j_ex.mixup(key, *(jnp.asarray(a) for a in
                                 (s_img, s_lab, t_img, t_lab)))
        k1, k2 = jax.random.split(key)
        perm = torch.from_numpy(np.array(jax.random.permutation(k1, 3)))
        lam = int((jax.random.beta(k2, 0.2, 0.2) * 10).astype(jnp.int32))
        got = ex.mixup(perm, lam, nchw(s_img), torch.from_numpy(s_lab),
                       nchw(t_img), torch.from_numpy(t_lab))
        for g, w in zip(got, want):
            g = nhwc(g) if g.dim() == 4 else g.numpy()
            np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------- models


DISCS = {
    "fc": (j_disc.FCDiscriminator, disc.FCDiscriminator, 64),
    "local": (j_disc.FCDiscriminatorLocal, disc.FCDiscriminatorLocal, 64),
    "pixel": (j_disc.PixelDiscriminator, disc.PixelDiscriminator, 16),
}


def flax_disc_params(module: torch.nn.Module, kind: str):
    """A port discriminator's weights as flax params (``Conv_i`` in the
    order of ``models/port.py``'s table): OIHW -> HWIO."""
    sd = module.state_dict()
    return {f"Conv_{i}": {
        "kernel": jnp.asarray(sd[f"{name}.weight"].numpy().transpose(2, 3, 1,
                                                                     0)),
        "bias": jnp.asarray(sd[f"{name}.bias"].numpy())}
        for i, name in enumerate(port._DISC_CONVS[kind])}


@pytest.mark.parametrize("kind", list(DISCS))
def test_discriminators_match_jax(kind):
    """Each discriminator: the port's seeded init has flax's parameter
    shapes (``jax.eval_shape`` of the flax init), LeCun-normal weights
    and zero biases; its weights as flax params, and back through
    ``discriminator_state_dict_from_jax`` unchanged; the forward on a
    (2, 6, hw, hw) softmax map (``FCDiscriminatorLocal`` upsampled back
    x32 with ``align_corners=False``) within 1e-5."""
    j_cls, t_cls, hw = DISCS[kind]
    ndf = 16 if kind == "pixel" else 8
    jm = j_cls(ndf=ndf)
    x = np.random.default_rng(2).random((2, hw, hw, C)).astype(np.float32)
    tm = t_cls(C, ndf=ndf, device="cpu",
               generator=torch.Generator().manual_seed(0))
    params = flax_disc_params(tm, kind)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))
    assert jax.tree.map(lambda a: a.shape, shapes["params"]) == \
        jax.tree.map(lambda a: a.shape, params)
    for k, v in tm.state_dict().items():
        if k.endswith("bias"):
            assert float(v.abs().max()) == 0
        else:   # variance 1 / fan-in
            fan_in = v[0].numel()
            assert 0.8 < float(v.std()) * fan_in ** 0.5 < 1.2, k
    sd = port.discriminator_state_dict_from_jax(
        jax.tree.map(np.asarray, params), kind)
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k
    with torch.no_grad():
        got = tm(nchw(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    close(nhwc(got), want)


def test_reduction_and_mmd_model_match_jax():
    """``DeeplabV2MMD`` at resnet18 (ASPP head, reduction to 512 / 8) from
    a seeded port model's weights, carried to flax through the JAX
    package's converter and back through ``mmd_state_dict_from_jax``:
    eval mode (softmax) and train mode (upsampled logits, reduced feature,
    BatchNorm on batch statistics) within 1e-5; the two ``mmd_linear``s
    on the reduced features."""
    from uemda_tpu.models.config import BackboneConfig as JaxBackbone
    from uemda_tpu.models.port_torch import port_deeplabv2
    from uemda_tpu_torch.models.config import BackboneConfig

    seeded = disc.DeeplabV2MMD(BackboneConfig(resnet_type="resnet18"),
                               num_classes=C, inchannels=512, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in seeded.state_dict().items()}
    v = port_deeplabv2(sd, use_ppm=False, multi_layer=False)
    v["params"]["reduction"] = {
        f"Dense_{i}": {"kernel": sd[f"reduction.fc{i + 1}.weight"].T,
                       "bias": sd[f"reduction.fc{i + 1}.bias"]}
        for i in range(2)}
    tm = disc.DeeplabV2MMD(BackboneConfig(resnet_type="resnet18"),
                           num_classes=C, inchannels=512, device="cpu")
    tm.load_state_dict(port.mmd_state_dict_from_jax(v), strict=False)
    for k, t in seeded.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(tm.state_dict()[k], t), k
    jm = j_disc.DeeplabV2MMD(JaxBackbone(resnet_type="resnet18"),
                             num_classes=C, inchannels=512)
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        got = tm(nchw(x))
    close(nhwc(got), jit(jm.apply, train=False)(v, jnp.asarray(x)))
    (j_logits, j_red), _ = jit(jm.apply, train=True, mutable=["batch_stats"])(
        v, jnp.asarray(x))
    tm.train()
    with torch.no_grad():
        t_logits, t_red = tm(nchw(x))
    close(nhwc(t_logits), j_logits)
    close(t_red, j_red)
    j_red = np.array(j_red)
    close(disc.mmd_linear(torch.from_numpy(j_red[:1]),
                          torch.from_numpy(j_red[1:])),
          j_disc.mmd_linear(j_red[:1], j_red[1:]))


def test_trans_norm_matches_jax():
    """``TransNorm2d`` from flax's init: a train step on [source; target]
    (output, gradients of the input and the affine, the four running
    statistics after the update), then eval on the target statistics."""
    r = np.random.default_rng(4)
    x = (r.normal(size=(4, 5, 5, 8)) * [[1.0] * 8] + np.arange(8)) \
        .astype(np.float32)
    x[2:] = x[2:] * 1.7 - 0.5
    jm = JaxTransNorm(8)
    v = jm.init(jax.random.key(0), jnp.asarray(x), train=True)
    v = jax.tree.map(np.asarray, v)
    cot = r.normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        out, mut = jm.apply({"params": params, "batch_stats":
                             v["batch_stats"]}, xx, train=True,
                            mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut["batch_stats"])

    (_, (j_out, j_stats)), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    tm = TransNorm2d(8)
    tm.load_state_dict(port.trans_norm_state_dict_from_jax(v))
    tm.train()
    tx = nchw(x).requires_grad_()
    out = tm(tx)
    (out * nchw(cot)).sum().backward()
    close(nhwc(out), j_out)
    close(nhwc(tx.grad), j_gx)
    close(tm.weight.grad, j_gp["scale"])
    close(tm.bias.grad, j_gp["bias"])
    for k in ("mean_source", "mean_target", "var_source", "var_target"):
        close(getattr(tm, k), j_stats[k])
    tm.eval()
    with torch.no_grad():
        got = tm(nchw(x))
    want = jm.apply({"params": v["params"], "batch_stats": j_stats},
                    jnp.asarray(x), train=False)
    close(nhwc(got), want)


# ---------------------------------------------------------- DCA, MMD


def _dca_inputs(seed, b=4, hw=4, k=16):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(b, hw, hw, n)) * s).astype(np.float32)
            for n, s in ((C, 2.0), (C, 2.0), (k, 1.0), (C, 2.0), (C, 2.0),
                         (k, 1.0))]


def test_dca_matches_jax():
    """``get_context`` (with and without the background class),
    ``_corrcoef_rows``, ``_regularize``, ICR, CCR -- the gradient through
    ``t_feats`` and none through ``s_feats`` -- and the MSE forms."""
    s1, s2, sf, t1, t2, tf = _dca_inputs(5)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(s1), -1))
    for bg in (False, True):
        close(dca.get_context(nchw(probs), nchw(sf), bg),
              jit(j_dca.get_context, ignore_bg=bg)(jnp.asarray(probs),
                                                   jnp.asarray(sf)))
    r = np.random.default_rng(6)
    a, b = r.normal(size=(5, 16)), r.normal(size=(5, 16))
    a, b = a.astype(np.float32), b.astype(np.float32)
    cor = dca._corrcoef_rows(torch.from_numpy(a), torch.from_numpy(b))
    close(cor, jit(j_dca._corrcoef_rows)(jnp.asarray(a), jnp.asarray(b)))
    close(dca._regularize(cor),
          jit(j_dca._regularize)(jnp.asarray(cor.numpy())))
    j_in = [jnp.asarray(t) for t in (s1, s2, sf, t1, t2, tf)]
    t_in = [nchw(t) for t in (s1, s2, sf, t1, t2, tf)]
    close(dca.icr(*t_in[:3], C), jit(j_dca.icr, num_classes=C)(*j_in[:3]))
    close(dca.mse_intra(*t_in[:3]), jit(j_dca.mse_intra)(*j_in[:3]))
    close(dca.mse_cross(*t_in), jit(j_dca.mse_cross)(*j_in))
    t_in[2].requires_grad_()
    t_in[5].requires_grad_()
    val = dca.ccr(*t_in, C)
    val.backward()
    jv, (jg_s, jg_t) = jax.jit(jax.value_and_grad(
        lambda s, t: j_dca.ccr(j_in[0], j_in[1], s, j_in[3], j_in[4], t, C),
        argnums=(0, 1)))(j_in[2], j_in[5])
    close(val, jv)
    close(nhwc(t_in[5].grad), jg_t)
    assert t_in[2].grad is None and float(jnp.abs(jg_s).max()) == 0


def test_mmd_losses_match_jax():
    """``mmd_linear`` (over the width) and ``mmd_rbf`` with the detached
    bandwidth heuristic and with a fixed sigma, and the gradient of
    ``mmd_rbf`` with respect to the source."""
    r = np.random.default_rng(7)
    s = r.normal(size=(6, 10)).astype(np.float32)
    t = (r.normal(size=(5, 10)) + 0.5).astype(np.float32)
    close(mmd.mmd_linear(torch.from_numpy(s), torch.from_numpy(t)),
          j_mmd.mmd_linear(jnp.asarray(s), jnp.asarray(t)))
    for kw in ({}, {"fix_sigma": 3.0}, {"kernel_mul": 3.0, "kernel_num": 3}):
        ts = torch.from_numpy(s).requires_grad_()
        val = mmd.mmd_rbf(ts, torch.from_numpy(t), **kw)
        val.backward()
        jv, jg = jax.jit(jax.value_and_grad(
            lambda a: j_mmd.mmd_rbf(a, jnp.asarray(t), **kw)))(jnp.asarray(s))
        close(val, jv)
        close(ts.grad, jg)


def test_ema_matches_jax():
    """``init_ema``, three ``update_ema`` steps and the swap, against the
    JAX pytree functions on the same parameters."""
    r = np.random.default_rng(8)
    lin = torch.nn.Linear(4, 3)
    shadow = ema.init_ema(lin)
    def params():   # copies: jnp.asarray of a numpy view may alias it
        return {n: jnp.asarray(p.detach().numpy().copy())
                for n, p in lin.named_parameters()}

    j_shadow = j_ema.init_ema(params())
    for i in range(3):
        with torch.no_grad():
            for p in lin.parameters():
                p.copy_(torch.from_numpy(r.normal(size=p.shape)
                                         .astype(np.float32)))
        ema.update_ema(shadow, lin, decay=0.9)
        j_shadow = j_ema.update_ema(j_shadow, params(), decay=0.9)
    for n in shadow:
        close(shadow[n], j_shadow[n])
    live = {n: p.detach().clone() for n, p in lin.named_parameters()}
    used, backup = ema.swap_in_ema(lin, shadow)
    for n, p in lin.named_parameters():
        assert torch.equal(p, shadow[n]) and torch.equal(backup[n], live[n])
    ema.swap_in_ema(lin, backup)
    for n, p in lin.named_parameters():
        assert torch.equal(p, live[n])


# ---------------------------------------------------------- whitening


def test_class_ware_whitening_matches_jax():
    """The loss over classes with many pixels, one pixel (the identity
    branch) and none, at 4 and 8 groups."""
    r = np.random.default_rng(9)
    feats = r.normal(size=(2, 5, 5, 16)).astype(np.float32)
    labels = r.integers(0, 3, (2, 5, 5)).astype(np.int32)
    labels[0, 0, 0] = 4     # class 4: one pixel
    for groups in (4, 8):
        close(whiten.class_ware_whitening_loss(
            nchw(feats), torch.from_numpy(labels), [0, 1, 2, 4, 5], groups),
            jit(j_wh.class_ware_whitening_loss, class_ids=(0, 1, 2, 4, 5),
                groups=groups)(jnp.asarray(feats), jnp.asarray(labels)))


def test_saw_matches_jax():
    """``saw_loss`` with distinct classifier weights (so the channel rank
    has no ties), two class selections and both margins."""
    r = np.random.default_rng(10)
    feats = r.normal(size=(2, 6, 6, 12)).astype(np.float32)
    w = r.permutation(C * 12).reshape(C, 12).astype(np.float32) / 50 - 0.7
    for sel, relax in (([0, 2, 3], 2.0), ([1, 4], 0.0)):
        close(saw.saw_loss(nchw(feats), torch.from_numpy(w), sel, relax),
              jit(j_saw.saw_loss, selected_classes=tuple(sel),
                  relax_denom=relax)(jnp.asarray(feats), jnp.asarray(w)))


def test_msc_matches_jax():
    """``msc_loss`` on source and target features with distinct
    similarities, at two (k, m, mu); at the second, the kept targets hold
    no class-2 label, so the class-2 source rows (no positive) count 0."""
    r = np.random.default_rng(11)
    s = r.normal(size=(24, 8)).astype(np.float32)
    labels = np.repeat(np.arange(4), 6).astype(np.int32)
    s += labels[:, None] * 0.8
    t = (r.normal(size=(10, 8)) + r.integers(0, 4, (10, 1)) * 0.8) \
        .astype(np.float32)
    for k, m, mu in ((5, 3, 8), (3, 2, 4)):
        close(msc.msc_loss(torch.from_numpy(s), torch.from_numpy(labels),
                           torch.from_numpy(t), 4, k, m, mu),
              jit(j_msc.msc_loss, num_classes=4, k=k, m=m, mu=mu)(
                  jnp.asarray(s), jnp.asarray(labels), jnp.asarray(t)))


# ---------------------------------------------------------- contrastive


def test_contrastive_losses_match_jax():
    """``triplet_loss``, ``contrastive_anchors`` and ``pixel_contrast_loss``
    on the uniform noise the JAX function draws from its key
    (``jax.random.uniform(rng, (B, N, C))``), with classes short of
    ``n_view`` pixels masked out."""
    r = np.random.default_rng(12)
    x = r.normal(size=(12, 6)).astype(np.float32)
    y = r.integers(0, 3, 12).astype(np.int32)
    close(contrastive.triplet_loss(torch.from_numpy(x), torch.from_numpy(y)),
          jit(j_con.triplet_loss)(jnp.asarray(x), jnp.asarray(y)))
    fa = r.normal(size=(5, 3, 6)).astype(np.float32)
    la = np.array([0, 1, 0, 2, 1], np.int32)
    close(contrastive.contrastive_anchors(torch.from_numpy(fa),
                                          torch.from_numpy(la)),
          jit(j_con.contrastive_anchors)(jnp.asarray(fa), jnp.asarray(la)))
    b, n, k = 2, 40, 8
    feats = r.normal(size=(b, n, k)).astype(np.float32)
    labels = r.integers(-1, 4, (b, n)).astype(np.int32)
    labels[1, labels[1] == 3] = 0     # class 3 short in image 1
    preds = r.integers(0, 4, (b, n)).astype(np.int32)
    rng = jax.random.key(3)
    noise = np.array(jax.random.uniform(rng, (b, n, 4)))
    close(contrastive.pixel_contrast_loss(
        torch.from_numpy(feats), torch.from_numpy(labels),
        torch.from_numpy(preds), torch.from_numpy(noise), 4, n_view=5),
        jit(j_con.pixel_contrast_loss, num_classes=4, n_view=5)(
            jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(preds),
            rng))


def test_domain_balance_matches_jax():
    """``examples_cnt`` over the port's in-memory split (hard labels and
    the arg-max of soft labels) and ``get_target_weight``, against the JAX
    functions on the same dataset object."""
    from uemda_tpu_torch.datasets.base import ArrayDataset
    from uemda_tpu_torch.datasets.meta import IsprsDA

    r = np.random.default_rng(13)
    labels = r.integers(-1, C, (3, 8, 8)).astype(np.int32)
    prob = r.random((3, 8, 8, C)).astype(np.float32)
    ds = ArrayDataset(IsprsDA, np.zeros((3, 8, 8, 3), np.uint8), labels,
                      prob=prob)
    for kw in ({}, {"prob_labels": True}, {"ignore_label": 2,
                                           "prob_labels": True}):
        assert domain_balance.examples_cnt(ds, **kw) == \
            j_db.examples_cnt(ds, **kw)
    for args in ((100.0, 0.5, 60.0, 0.6), (50.0, 0.9, 80.0, 0.3)):
        assert domain_balance.get_target_weight(*args) == \
            j_db.get_target_weight(*args)

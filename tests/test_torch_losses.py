"""The port's loss zoo on the CPU against the JAX package's
(``uemda_tpu/alignment/losses.py``): OHEM, focal, GHM and GDP with their
histogram state, and UPS, on seeded logits with ignored pixels -- the
losses, their gradients and the histogram state; the GHM/GDP bin edges and
binning bit for bit, with values on every edge and an ulp either side;
OHEM's k from each of its two terms; an all-ignored batch; and the
stage-3 target loss of every ``--lt`` on the combo mix step's pasted map
(``_target_loss``), with its class-balance gating."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uemda_tpu.alignment import losses as jl
from uemda_tpu_torch.alignment import losses as tl

C = 6
B, H, W = 2, 12, 10


def _case(seed, ignore_frac=0.2, scale=2.0):
    """NHWC logits and (B, H, W) labels (a share ignored), soft labels
    (B, H, W, C) with varying confidence and a class-balance-like pixel
    weight in [0.1, 1]."""
    r = np.random.default_rng(seed)
    logits = (r.normal(size=(B, H, W, C)) * scale).astype(np.float32)
    labels = r.integers(0, C, (B, H, W)).astype(np.int32)
    labels[r.random((B, H, W)) < ignore_frac] = -1
    sharp = r.choice([0.5, 2.0, 8.0], (B, H, W, 1))
    z = r.normal(size=(B, H, W, C)) * sharp
    soft = np.exp(z - z.max(-1, keepdims=True))
    soft = (soft / soft.sum(-1, keepdims=True)).astype(np.float32)
    weight = r.uniform(0.1, 1.0, (B * H * W,)).astype(np.float32)
    return logits, labels, soft, weight


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# name -> (JAX (logits NHWC, labels, soft, weight) -> loss,
#          port (logits NCHW, labels, soft NCHW, weight) -> loss)
ZOO = {
    "ohem": (lambda lg, lb, s, w: jl.ohem_cross_entropy(lg, lb, -1),
             lambda lg, lb, s, w: tl.ohem_cross_entropy(lg, lb, -1)),
    "ohem_weighted": (
        lambda lg, lb, s, w: jl.ohem_cross_entropy(lg, lb, -1, pixel_weight=w),
        lambda lg, lb, s, w: tl.ohem_cross_entropy(lg, lb, -1, pixel_weight=w)),
    "focal": (lambda lg, lb, s, w: jl.focal_loss(lg, lb, 2.0, -1),
              lambda lg, lb, s, w: tl.focal_loss(lg, lb, 2.0, -1)),
    "ups": (lambda lg, lb, s, w: jl.ups_loss(lg, lb, s, 0.7, -1),
            lambda lg, lb, s, w: tl.ups_loss(lg, lb, s, 0.7, -1)),
    "ups_weighted": (
        lambda lg, lb, s, w: jl.ups_loss(lg, lb, s, 0.7, -1, pixel_weight=w),
        lambda lg, lb, s, w: tl.ups_loss(lg, lb, s, 0.7, -1, pixel_weight=w)),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_loss_and_gradient_match_jax(name):
    """Each loss and its gradient with respect to the logits, f32: the loss
    within 1e-5 relative, the gradient within 1e-6 of its largest entry;
    UPS also from K8's ``u`` (the stage-3 step's route) equal to the
    ``label_soft`` route."""
    jfn, tfn = ZOO[name]
    for seed in (0, 1):
        logits, labels, soft, weight = _case(seed)
        jloss, jgrad = jax.value_and_grad(
            lambda x: jfn(x, jnp.asarray(labels), jnp.asarray(soft),
                          jnp.asarray(weight)))(jnp.asarray(logits))
        x = _nchw(logits).requires_grad_(True)
        tloss = tfn(x, torch.from_numpy(labels), _nchw(soft),
                    torch.from_numpy(weight))
        tloss.backward()
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   rtol=1e-5, err_msg=f"{name} seed {seed}")
        g = x.grad.permute(0, 2, 3, 1).numpy()
        jg = np.asarray(jgrad)
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6 * np.abs(jg).max())
        assert float(tloss.detach()) > 0
    if name == "ups":
        from uemda_tpu_torch.ops.uncertainty import pixel_entropy

        u = pixel_entropy(_nchw(soft), dim=1)
        via_u = tl.ups_loss(_nchw(logits), torch.from_numpy(labels), None,
                            0.7, -1, u=u)
        assert float(via_u) == float(tl.ups_loss(
            _nchw(logits), torch.from_numpy(labels), _nchw(soft), 0.7, -1))


@pytest.mark.parametrize("kind", ["ghm", "gdp", "gdp_weighted"])
def test_ghm_and_gdp_match_jax_over_two_calls(kind):
    """GHM and GDP, jitted on the JAX side as in its train step: two calls
    threading the histogram state (the second on other logits), the loss
    within 1e-5 relative, ``acc_sum`` within 1e-6, the gradient within
    1e-6 of its largest entry. GDP with the pixel weight divides by two
    weight terms."""
    fn_j, fn_t = (jl.ghm_loss, tl.ghm_loss) if kind == "ghm" else \
        (jl.gdp_loss, tl.gdp_loss)
    acc_j = jnp.zeros((30,), jnp.float32)
    acc_t = torch.zeros(30)
    for call in range(2):
        logits, labels, _, weight = _case(10 + call, scale=3.0)
        kw_j, kw_t = {}, {}
        if kind == "gdp_weighted":
            kw_j = dict(pixel_weight=jnp.asarray(weight), n_weight_terms=2)
            kw_t = dict(pixel_weight=torch.from_numpy(weight),
                        n_weight_terms=2)

        def jloss(x, acc):
            return fn_j(x, jnp.asarray(labels), jl.GHMState(acc, 0.99, 30),
                        -1, **kw_j)

        (lj, st_j), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jnp.asarray(logits), acc_j)
        x = _nchw(logits).requires_grad_(True)
        lt, st_t = fn_t(x, torch.from_numpy(labels),
                        tl.GHMState(acc_t, 0.99, 30), -1, **kw_t)
        lt.backward()
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5,
                                   err_msg=f"{kind} call {call}")
        np.testing.assert_allclose(st_t.acc_sum.numpy(),
                                   np.asarray(st_j.acc_sum), rtol=1e-6,
                                   atol=1e-7)
        jg = np.asarray(gj)
        np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), jg,
                                   rtol=0, atol=1e-6 * np.abs(jg).max())
        acc_j, acc_t = st_j.acc_sum, st_t.acc_sum.detach()
    assert float(acc_t.sum()) > 0


def _jax_binning(g, bins=30):
    """``_ghm_gradient_and_bins``' two edge sets and its histogram and
    bucket index of ``g``, the JAX package's expressions under ``jit``."""
    def run(g):
        edges = jnp.concatenate([jnp.arange(bins, dtype=jnp.float32) / bins,
                                 jnp.array([1.0 + 1e-3])])
        hist, hist_edges = jnp.histogram(g, bins=bins, range=(0.0, 1.0))
        return (hist_edges, edges, hist.astype(jnp.float32),
                jnp.searchsorted(edges, g, side="left"))
    return [np.asarray(a) for a in jax.jit(run)(jnp.asarray(g))]


def test_bin_edges_and_binning_match_jax_bit_for_bit():
    """The histogram's and the bucket index's f32 edges equal the jitted
    JAX step's bit for bit, and so do the histogram and the bucket indices
    of g exactly on every edge, one ulp above and below it, 0, 1, the
    ignored -1 and random values. (Subnormals are left out: XLA on the CPU
    flushes them to 0; g = |p_y - 1| is 0 or at least 2^-24.)"""
    hist_e, search_e = tl.ghm_edges(30)
    want_hist_e, want_search_e, _, _ = _jax_binning(np.zeros(3, np.float32))
    assert hist_e.dtype == search_e.dtype == torch.float32
    np.testing.assert_array_equal(hist_e.numpy().view(np.int32),
                                  want_hist_e.view(np.int32))
    np.testing.assert_array_equal(search_e.numpy().view(np.int32),
                                  want_search_e.view(np.int32))
    edges = np.unique(np.concatenate([want_hist_e, want_search_e]))
    inner = edges[edges > 0]
    g = np.concatenate([
        edges, np.nextafter(inner, np.float32(2)),
        np.nextafter(inner, np.float32(-2)), [0.0, 1.0, -1.0, -1.0],
        np.random.default_rng(0).random(500)]).astype(np.float32)
    _, _, want_hist, want_inds = _jax_binning(g)
    hist, inds = tl.ghm_bins(torch.from_numpy(g), 30)
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    np.testing.assert_array_equal(inds.numpy(), want_inds)
    assert float(hist.sum()) == (g >= 0).sum() - (g > 1).sum()


def test_all_ignored_batch_matches_jax():
    """A batch with every label ignored: every zoo loss finite and equal to
    JAX's (0 for OHEM, UPS, GHM and GDP; focal averages zeros), the
    histogram state only decays."""
    logits, labels, soft, weight = _case(3)
    labels[:] = -1
    lj, lbj, sj = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(soft)
    lt, lbt, st = _nchw(logits), torch.from_numpy(labels), _nchw(soft)
    pairs = [(jl.ohem_cross_entropy(lj, lbj), tl.ohem_cross_entropy(lt, lbt)),
             (jl.focal_loss(lj, lbj), tl.focal_loss(lt, lbt)),
             (jl.ups_loss(lj, lbj, sj), tl.ups_loss(lt, lbt, st))]
    acc0 = np.linspace(0.0, 5.0, 30).astype(np.float32)
    for fn_j, fn_t in ((jl.ghm_loss, tl.ghm_loss), (jl.gdp_loss, tl.gdp_loss)):
        a, sa = jax.jit(lambda x, y, acc: fn_j(
            x, y, jl.GHMState(acc, 0.99, 30)))(lj, lbj, jnp.asarray(acc0))
        b, sb = fn_t(lt, lbt, tl.GHMState(torch.from_numpy(acc0), 0.99, 30))
        pairs.append((a, b))
        np.testing.assert_allclose(sb.acc_sum.numpy(), np.asarray(sa.acc_sum),
                                   rtol=1e-6)
    for a, b in pairs:
        assert np.isfinite(float(b))
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6, atol=0)


def test_ohem_k_from_each_term():
    """OHEM's k = max(#valid // 5, #(ce > -log 0.7)): confident logits put
    fewer than a fifth of the pixels over the threshold, so k is the fifth;
    flat logits put most over it, so k is their count. Both against JAX
    (1e-5 relative) and against the top-k mean computed in numpy."""
    logits, labels, _, _ = _case(4)
    onehot = np.eye(C, dtype=np.float32)[labels.clip(0)] * 12.0
    confident = onehot + np.random.default_rng(5).normal(
        size=logits.shape).astype(np.float32)
    flat = logits * 0.05
    thresh = float(-np.log(np.float32(0.7)))
    for x, k_from in ((confident, "n_min"), (flat, "count")):
        want = float(jl.ohem_cross_entropy(jnp.asarray(x),
                                           jnp.asarray(labels)))
        got = float(tl.ohem_cross_entropy(_nchw(x), torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k_from)
        ce = tl.cross_entropy_per_pixel(
            _nchw(x).permute(0, 2, 3, 1).reshape(-1, C),
            torch.from_numpy(labels).reshape(-1)).numpy()
        n_min = (labels != -1).sum() // 5
        count = int((ce > thresh).sum())
        assert (count < n_min) if k_from == "n_min" else (count > n_min)
        k = max(n_min, count)
        np.testing.assert_allclose(got, np.sort(ce)[::-1][:k].mean(),
                                   rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _resnet18():
    from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config

    return DeeplabV2(DeeplabV2Config.uemda_default(C, resnet_type="resnet18"),
                     device="cpu")


@pytest.mark.parametrize("loss", ["uvem", "ups", "ohem", "focal", "ghm",
                                  "gdp", "ce"])
def test_target_loss_on_a_pasted_map_matches_jax(loss):
    """The combo mix step's target loss for every ``--lt``: the port's
    ``_target_loss`` reads K8's ``(w, u)`` of the unmixed soft label and the
    paste mask, JAX's ``_target_loss`` the pasted soft map (one-hot source
    labels on the paste, ``steps.py:445-452``), both heads upsampled from
    stride 16, the target class balance on. The loss 1e-5 relative; the
    class balance (moved for uvem, ups, gdp and ce only) 1e-6; the GHM/GDP
    histogram 1e-6."""
    import types

    from uemda_tpu.alignment.balance import init_class_balance as jax_balance
    from uemda_tpu.alignment.losses import init_ghm as jax_init_ghm
    from uemda_tpu.ops.labels import one_hot_ignore
    from uemda_tpu.train.steps import StageHParams as JaxHParams
    from uemda_tpu.train.steps import _target_loss as jax_target_loss
    from uemda_tpu_torch.alignment.balance import init_class_balance
    from uemda_tpu_torch.alignment.losses import init_ghm
    from uemda_tpu_torch.ops.mine import uvem_mine
    from uemda_tpu_torch.train.steps import StageHParams, make_ssl_step

    r = np.random.default_rng(5)
    b, hw = 2, 32
    preds = [r.normal(size=(b, 2, 2, C)).astype(np.float32) * 3
             for _ in range(2)]
    z = r.normal(size=(b, hw, hw, C)) * np.kron(
        r.choice([0.5, 4.0, 12.0], (b, 4, 4)), np.ones((8, 8)))[..., None]
    soft = np.exp(z - z.max(-1, keepdims=True))
    soft = (soft / soft.sum(-1, keepdims=True)).astype(np.float32)
    src = r.integers(-1, C, (b, hw, hw)).astype(np.int32)
    paste = np.kron(r.random((b, 4, 4)) < 0.4, np.ones((8, 8))).astype(bool)
    hp = StageHParams(class_num=C, target_loss=loss, balance_target=True,
                      refine=False)
    step = make_ssl_step(_resnet18(), hp)
    label_t, w, u = uvem_mine(torch.from_numpy(soft).permute(0, 3, 1, 2),
                              hp.cutoff_top, hp.cutoff_low, hp.uvem_m,
                              hp.uvem_t, hp.uvem_g)
    lab = np.where(paste, src, label_t.numpy()).astype(np.int32)
    state = types.SimpleNamespace(balance_t=init_class_balance(C, 0.99, 2.0),
                                  ghm=init_ghm())
    got = step._target_loss(
        state, [torch.from_numpy(p).permute(0, 3, 1, 2) for p in preds],
        torch.from_numpy(lab), w, u, paste_mask=torch.from_numpy(paste))
    soft_t = np.where(paste[..., None],
                      np.asarray(one_hot_ignore(jnp.asarray(src), C)), soft)
    jstate = types.SimpleNamespace(balance_t=jax_balance(C, 0.99, 2.0),
                                   ghm=jax_init_ghm())
    want, balance, ghm = jax_target_loss(
        JaxHParams(class_num=C, target_loss=loss, balance_target=True),
        jstate, [jnp.asarray(p) for p in preds], jnp.asarray(lab),
        jnp.asarray(soft_t), paste_mask=jnp.asarray(paste))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(got) > 0
    np.testing.assert_allclose(state.balance_t.freq.numpy(),
                               np.asarray(balance.freq), rtol=1e-6)
    assert np.allclose(state.balance_t.freq.numpy(), 1.0 / C) == (
        loss not in ("uvem", "ups", "gdp", "ce"))
    np.testing.assert_allclose(state.ghm.acc_sum.numpy(),
                               np.asarray(ghm.acc_sum), rtol=1e-6, atol=1e-7)

"""Stage-2 label and prototype maths of the port on the CPU against the JAX
package: ``downscale_label`` and pseudo selection (exact), then
``pearson_dist``, the prototype updates, every ``label_refine`` view, the
margin losses, the target-weighted update, the per-pixel prototype weight
and PCL (value and gradient) at 1e-5.

Inputs are drawn with numpy from a seed and handed to both packages; the
port takes NCHW (features (B, K, h, w), soft labels (B, C, H, W)), the JAX
package NHWC, converted by the shared helpers. The 1e-5 tolerances cover
f32 sums taken in another order (matrix products, means over 16-1024
terms) and, in ``label_refine``, the inverse of a Pearson distance near
0.5, which doubles a relative error."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import to_nhwc, to_torch
from uemda_tpu.alignment import pcl as jpcl
from uemda_tpu.alignment import prototypes as jp
from uemda_tpu.ops import labels as jlabels
from uemda_tpu.ops import pseudo as jpseudo
from uemda_tpu_torch.alignment import prototypes as tp
from uemda_tpu_torch.alignment.pcl import prototype_contrastive_loss
from uemda_tpu_torch.datasets.synthetic import grid_superpixels
from uemda_tpu_torch.models.port import aligner_from_jax
from uemda_tpu_torch.ops.labels import downscale_label, one_hot_ignore
from uemda_tpu_torch.ops.pseudo import (
    pseudo_selection,
    pseudo_selection_threshold,
)

C, K, B = 6, 24, 2
h = w = 6            # feature map (stride 16)
H = W = 96           # label map
TOL = dict(rtol=1e-5, atol=1e-5)


def _blocky(r, b, hw, cell, lo=-1, hi=C):
    g = r.integers(lo, hi, (b, hw // cell, hw // cell))
    return np.kron(g, np.ones((1, cell, cell), np.int64)).astype(np.int32)


def _label(seed):
    """Cells mostly of one class with noise and ignore pixels, so the 16x16
    vote sees clear winners, ties, ignore winners and ratios near 0.75."""
    r = np.random.default_rng(seed)
    lab = _blocky(r, B, H, 16, 0, C)
    noise = r.random(lab.shape)
    lab = np.where(noise < 0.2, r.integers(-1, C, lab.shape), lab)
    lab[0, :16, :16] = -1
    lab[1, :16, :16] = np.kron([[1, 2], [2, 1]], np.ones((8, 8), np.int32))
    return lab.astype(np.int32)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def _case(seed=0):
    r = np.random.default_rng(seed)
    feat = r.normal(size=(B, h, w, K)).astype(np.float32)
    proto = r.normal(size=(C, K)).astype(np.float32)
    preds = [r.normal(size=(B, h, w, C)).astype(np.float32) * 2 for _ in range(2)]
    soft = _softmax(r.normal(size=(B, H, W, C)) * 3)
    sup = np.stack([grid_superpixels(H, 16), np.roll(grid_superpixels(H, 16), 5)])
    return feat, proto, preds, soft, sup


def _states(proto):
    js = jp.init_aligner(C, K, prototypes=jnp.asarray(proto))
    return js, aligner_from_jax(js, device="cpu")


def _nchw(x):
    return to_torch(x)


def test_downscale_label_is_exact():
    lab = _label(1)
    for ratio in (0.75, 0.5):
        want = np.asarray(jlabels.downscale_label(jnp.asarray(lab), 16, C, -1,
                                                  ratio))
        got = downscale_label(torch.from_numpy(lab), 16, C, -1, ratio).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
    assert (got == -1).any() and (got >= 0).any()
    oh = one_hot_ignore(torch.from_numpy(lab), C).numpy()
    np.testing.assert_array_equal(
        oh, np.asarray(jlabels.one_hot_ignore(jnp.asarray(lab), C)))


def test_pseudo_selection_is_exact():
    r = np.random.default_rng(2)
    probs = _softmax(r.normal(size=(B, 32, 32, C)) * 4)
    probs[0, 0, 0] = [0.5, 0.5, 0, 0, 0, 0]          # two classes pass
    tp_ = _nchw(probs)
    for top, low in ((0.8, 0.6), (0.5, 0.3)):
        want = np.asarray(jpseudo.pseudo_selection(jnp.asarray(probs), top, low))
        got = pseudo_selection(tp_, top, low).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(jpseudo.pseudo_selection_threshold(
            jnp.asarray(probs), top, low))
        np.testing.assert_array_equal(
            pseudo_selection_threshold(tp_, top, low).numpy(), want)
    assert (got == -1).any() and (got >= 0).any()


def test_pearson_dist_and_prototype_updates_match_jax():
    """``pearson_dist`` (no gradient), ``compute_local_prototypes`` with an
    absent class, the EMA ``update_prototype``, ``update_avg`` twice and
    ``init_avg``."""
    feat, proto, _, _, _ = _case(3)
    lab = _label(4)
    lab[:, :, :] = np.where(lab == 5, 4, lab)               # class 5 absent
    js, ts = _states(proto)
    tfeat = _nchw(feat).requires_grad_()
    d = tp.pearson_dist(tp.pixels(tfeat), ts.prototypes)
    assert not d.requires_grad
    np.testing.assert_allclose(
        d.numpy(), np.asarray(jp.pearson_dist(jnp.asarray(feat.reshape(-1, K)),
                                              jnp.asarray(proto))), **TOL)
    js2, jdown = jp.update_prototype(js, jnp.asarray(feat), jnp.asarray(lab), C)
    ts2, tdown = tp.update_prototype(ts, tfeat, torch.from_numpy(lab), C)
    np.testing.assert_array_equal(tdown.numpy(), np.asarray(jdown))
    np.testing.assert_allclose(ts2.prototypes.numpy(),
                               np.asarray(js2.prototypes), **TOL)
    # the absent class keeps its prototype (up to the EMA's f32 rounding)
    np.testing.assert_allclose(ts2.prototypes[5].numpy(), proto[5], rtol=1e-6)
    for seed in (5, 6):
        f = np.random.default_rng(seed).normal(size=feat.shape).astype(np.float32)
        js = jp.update_avg(js, jnp.asarray(f), jnp.asarray(lab), C)
        ts = tp.update_avg(ts, _nchw(f), torch.from_numpy(lab), C)
    np.testing.assert_array_equal(ts.data_cnt.numpy(), np.asarray(js.data_cnt))
    np.testing.assert_allclose(ts.data_sum.numpy(), np.asarray(js.data_sum),
                               **TOL)
    np.testing.assert_allclose(tp.init_avg(ts).prototypes.numpy(),
                               np.asarray(jp.init_avg(js).prototypes), **TOL)


@pytest.mark.parametrize("mode", ["all", "p", "l", "s", "n"])
def test_label_refine_matches_jax(mode):
    """Every view, with both heads' logits and the superpixel map whose
    boundary id is the batch's max."""
    feat, proto, preds, soft, sup = _case(7)
    js, ts = _states(proto)
    want = np.asarray(jp.label_refine(
        js, jnp.asarray(soft), jnp.asarray(feat),
        [jnp.asarray(p) for p in preds], sup=jnp.asarray(sup), mode=mode,
        max_segments=64))
    got = tp.label_refine(ts, _nchw(soft), _nchw(feat),
                          [_nchw(p) for p in preds], sup=torch.from_numpy(sup),
                          mode=mode, max_segments=64)
    assert got.shape == (B, C, H, W)
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)
    np.testing.assert_allclose(to_nhwc(got).sum(-1), 1.0, atol=1e-5)
    assert not np.allclose(want, soft, atol=1e-3)    # the view did something


def test_label_refine_single_head_and_without_superpixels():
    """One logit map for the 'l' view; 'all' without a superpixel map is
    'p' + 'l'."""
    feat, proto, preds, soft, _ = _case(8)
    js, ts = _states(proto)
    for mode in ("l", "all"):
        want = np.asarray(jp.label_refine(js, jnp.asarray(soft), jnp.asarray(feat),
                                          jnp.asarray(preds[0]), mode=mode))
        got = tp.label_refine(ts, _nchw(soft), _nchw(feat), _nchw(preds[0]),
                              mode=mode)
        np.testing.assert_allclose(to_nhwc(got), want, **TOL)
    with pytest.raises(ValueError, match="mode"):
        tp.label_refine(ts, _nchw(soft), _nchw(feat), _nchw(preds[0]), mode="x")


def test_margin_losses_target_update_and_pixel_weight_match_jax():
    """``align_class`` and ``align_instance`` (source only and with the
    target), ``update_prototype_by_target`` and
    ``prototype_weight_for_pixels``."""
    feat, proto, _, soft, _ = _case(9)
    feat_t = np.random.default_rng(10).normal(size=feat.shape).astype(np.float32)
    lab_s, lab_t = _label(11), _label(12)
    js, ts = _states(proto)
    args_j = (jnp.asarray(feat), jnp.asarray(lab_s), C)
    args_t = (_nchw(feat), torch.from_numpy(lab_s), C)
    extra_j = (jnp.asarray(feat_t), jnp.asarray(lab_t))
    extra_t = (_nchw(feat_t), torch.from_numpy(lab_t))
    for fn_j, fn_t in ((jp.align_class, tp.align_class),
                       (jp.align_instance, tp.align_instance)):
        np.testing.assert_allclose(float(fn_t(ts, *args_t)),
                                   float(fn_j(js, *args_j)), **TOL)
        np.testing.assert_allclose(float(fn_t(ts, *args_t, *extra_t)),
                                   float(fn_j(js, *args_j, *extra_j)), **TOL)
    want = jp.update_prototype_by_target(js, jnp.asarray(feat), jnp.asarray(soft))
    got = tp.update_prototype_by_target(ts, _nchw(feat), _nchw(soft))
    np.testing.assert_allclose(got.prototypes.numpy(),
                               np.asarray(want.prototypes), **TOL)
    want = jp.prototype_weight_for_pixels(js, jnp.asarray(feat),
                                          jnp.asarray(lab_s), C)
    got = tp.prototype_weight_for_pixels(ts, _nchw(feat), torch.from_numpy(lab_s),
                                         C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pcl_value_and_gradient_match_jax():
    """PCL with ignored pixels (and a batch with none valid, where the mean
    is over max(0, 1)); the gradient reaches the features, not the
    prototypes."""
    feat, proto, _, _, _ = _case(13)
    lab = np.random.default_rng(14).integers(-1, C, (B, h, w)).astype(np.int32)
    tproto = torch.from_numpy(proto).requires_grad_()
    for labels in (lab, np.full_like(lab, -1)):
        jfn = lambda f: jpcl.prototype_contrastive_loss(
            jnp.asarray(proto), f, jnp.asarray(labels), 8.0)
        want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(feat))
        tfeat = _nchw(feat).requires_grad_()
        got = prototype_contrastive_loss(tproto, tfeat, torch.from_numpy(labels),
                                         8.0)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
        np.testing.assert_allclose(to_nhwc(tfeat.grad), np.asarray(jgrad),
                                   rtol=1e-5, atol=1e-7)
    assert tproto.grad is None

"""Stage 3's mining, losses, class balance, soft-label data and pseudo-label
sweep of the port on the CPU against the JAX package.

Inputs are drawn with numpy from a seed and handed to both packages; the
port takes NCHW soft labels (B, C, H, W), the JAX package NHWC. Tolerances:
K8's plain version against ``uvem_mine_pallas`` (interpret mode) and the
XLA ops at the tolerances of ``tests/test_pallas_mine_crop.py:26-28`` --
labels equal, u rtol 1e-6, w rtol 1e-5 (the pow of a clipped parabola) --
with one precision: w = v^(1/gamma) of the clipped parabola v, whose slope
is unbounded as v -> 0 (u near t). One rounding more or less in v -- an
FMA where the other route multiplies and adds, as the JAX package's own two
routes differ -- or an entropy one rounding off (the frameworks' ``log``
differ in the last bit) moves w there by up to 7e-4 relative. So w is held
at rtol 1e-5 / atol 1e-7 exactly against the reference's weight of the
port's own u, and against the reference's w at that tolerance plus what a
change of 2^-21 in v can do to v^(1/gamma) (:func:`_assert_w_close`). On
the card the kernel and the plain version are held bit-tight, since both
take one order and the same ``logf`` (``chip_smoke.py``). The losses and
the class balance 1e-6 relative (f32 sums over a few thousand pixels in
another order)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, jax_aug_draws
from uemda_tpu.alignment import balance as jbalance
from uemda_tpu.alignment import losses as jlosses
from uemda_tpu.ops import pseudo as jpseudo
from uemda_tpu.ops import uncertainty as junc
from uemda_tpu.ops.pallas_kernels import uvem_mine_pallas
from uemda_tpu_torch.alignment import balance as tbalance
from uemda_tpu_torch.alignment import losses as tlosses
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.ops.mine import uvem_mine, uvem_mine_plain
from uemda_tpu_torch.ops.uncertainty import pixel_entropy, uvem_weight

C = 6


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _probs(seed, b=2, h=24, w=40, c=C, nan=False):
    """Soft labels whose entropies cover all three UVEM branches (peaked,
    middling and flat pixels) and whose selection gives one class, none and
    several; one-hot rows hold exact zeros (u = 0) and, with ``nan``, one
    probability of sample 1 is NaN."""
    r = np.random.default_rng(seed)
    scale = r.choice([0.3, 2.0, 8.0], size=(b, h, w, 1))
    p = _softmax(r.normal(size=(b, h, w, c)) * scale)
    p[0, 0, :5] = np.eye(c, dtype=np.float32)[:5]          # exact zeros
    p[0, 1, 0] = [0.5, 0.5] + [0.0] * (c - 2)               # two classes pass
    p[1, 2, 3] = 1.0 / c                                     # flat: u = log C
    p = p.astype(np.float16).astype(np.float32)              # as stored
    if nan:
        p[1, 5, 7, 2] = np.nan
    return p


def _nchw(p):
    return torch.from_numpy(np.ascontiguousarray(p.transpose(0, 3, 1, 2)))


def _assert_w_close(w, want, gamma, delta=2.0 ** -21):
    """|w - want| <= 1e-7 + 1e-5 |want| + the most a change of ``delta`` in
    the parabola's value v moves v^(1/gamma): min(delta^(1/gamma),
    delta / gamma * min(w, want)^(1 - gamma))."""
    lo = np.maximum(np.minimum(w, want), 1e-30).astype(np.float64)
    slack = np.minimum(delta ** (1 / gamma), delta / gamma * lo ** (1 - gamma))
    d = np.abs(w.astype(np.float64) - want)
    bad = d > 1e-7 + 1e-5 * np.abs(want) + slack
    bad &= ~(np.isnan(w) & np.isnan(want))
    assert not bad.any(), (int(bad.sum()), w[bad][:5], want[bad][:5])


def _jax_mine(p, top, low, m, t, g):
    jp = jnp.asarray(p)
    u = junc.pixel_entropy(jp)
    return (np.asarray(jpseudo.pseudo_selection(jp, top, low)),
            np.asarray(junc.uvem_weight(u, m, t, g)), np.asarray(u))


@pytest.mark.parametrize("m,t", [(0.2, 0.7), (0.0, 0.5), (0.6, 0.5)])
@pytest.mark.parametrize("nan", [False, True])
def test_uvem_mine_plain_matches_the_pallas_kernel_and_the_xla_ops(m, t, nan):
    """The three branches, the degenerate (m, t) pairs (no left parabola; no
    right one), exact zeros and a NaN probability (its pixel's u is NaN and
    takes the right branch's weight; no pixel of that sample selects its
    class), against ``uvem_mine_pallas`` in interpret mode and against
    pseudo_selection + pixel_entropy + uvem_weight. The port reads any
    layout: the NCHW planes and the channels_last view give the same."""
    p = _probs(1, nan=nan)
    top, low, g = 0.8, 0.6, 4.0
    want_x = _jax_mine(p, top, low, m, t, g)
    lab_k, w_k, u_k = (np.asarray(a) for a in uvem_mine_pallas(
        jnp.asarray(p), top, low, m, t, g))
    for tp_ in (_nchw(p), torch.from_numpy(p).permute(0, 3, 1, 2)):
        lab, w, u = (a.numpy() for a in uvem_mine(tp_, top, low, m, t, g))
        np.testing.assert_allclose(
            w, np.asarray(junc.uvem_weight(jnp.asarray(u), m, t, g)),
            rtol=1e-5, atol=1e-7)
        for want_l, want_w, want_u in (want_x, (lab_k, w_k, u_k)):
            np.testing.assert_array_equal(lab, want_l)
            np.testing.assert_allclose(u, want_u, rtol=1e-6, atol=1e-7)
            _assert_w_close(w, want_w, g)
    u_flat = u.reshape(-1)
    assert (u_flat[np.isfinite(u_flat)] == 0).any()
    assert (lab == -1).any() and (lab >= 0).any()
    if m < t and not nan:
        assert ((u <= m).any() and ((u > m) & (u < t)).any()
                and (u >= t).any())
        assert ((w > 0) & (w < 1)).any()
    if nan:
        assert np.isnan(u[1, 5, 7])
        assert not (lab[1] == 2).any()


def test_uvem_mine_is_its_plain_version_on_the_cpu():
    """On a CPU tensor the wrapper is the plain version, launches nothing,
    and takes fp16 soft labels (cast to f32, exact)."""
    p = _nchw(_probs(2))
    n = uvem_mine.launches
    for x in (p, p.half()):
        got = uvem_mine(x, 0.8, 0.6, 0.2, 0.7, 4.0)
        want = uvem_mine_plain(x.float(), 0.8, 0.6, 0.2, 0.7, 4.0)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert uvem_mine.launches == n
    assert torch.equal(pixel_entropy(p), uvem_mine_plain(p)[2])
    assert torch.equal(uvem_weight(pixel_entropy(p)), uvem_mine_plain(p)[1])


def _logits_labels(seed, b=2, h=24, w=40):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(b, h, w, C)).astype(np.float32) * 2
    labels = r.integers(-1, C, (b, h, w)).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pasted", [False, True])
def test_uvem_loss_matches_jax(weighted, pasted):
    """``uvem_loss`` with and without the class-balance pixel weight and
    the paste mask, from the soft label (JAX's signature) and from the
    (w, u) that K8 mined (the stage-3 step's call): 1e-6 relative, and the
    two port forms equal."""
    logits, labels = _logits_labels(3)
    soft = _probs(4)
    r = np.random.default_rng(5)
    pw = r.uniform(0.2, 1.0, labels.size).astype(np.float32) if weighted \
        else None
    pm = (r.random(labels.shape) < 0.2) if pasted else None
    want = float(jlosses.uvem_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(soft), 0.2, 0.7,
        4.0, -1, None if pw is None else jnp.asarray(pw),
        paste_mask=None if pm is None else jnp.asarray(pm)))
    tl = torch.from_numpy(logits).permute(0, 3, 1, 2)
    kw = dict(m=0.2, threshold=0.7, gamma=4.0, ignore_label=-1,
              pixel_weight=None if pw is None else torch.from_numpy(pw),
              paste_mask=None if pm is None else torch.from_numpy(pm))
    got = tlosses.uvem_loss(tl, torch.from_numpy(labels), _nchw(soft), **kw)
    _, w, u = uvem_mine_plain(_nchw(soft))
    mined = tlosses.uvem_loss(tl, torch.from_numpy(labels), w=w, u=u, **kw)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(mined) == float(got) and want > 0


def test_loss_calc_uvem_and_weighted_ce_match_jax():
    """Both heads upsampled to the label (align_corners) and averaged; the
    CE's pixel weight multiplies each pixel's CE before the mean."""
    r = np.random.default_rng(6)
    heads = [r.normal(size=(2, 6, 10, C)).astype(np.float32) for _ in range(2)]
    _, labels = _logits_labels(7)
    soft = _probs(8)
    fn = lambda lg, lb, ls: jlosses.uvem_loss(lg, lb, ls)  # noqa: E731
    want = float(jlosses.loss_calc_uvem([jnp.asarray(x) for x in heads],
                                        jnp.asarray(labels),
                                        jnp.asarray(soft), fn))
    got = float(tlosses.loss_calc_uvem(
        [torch.from_numpy(x).permute(0, 3, 1, 2) for x in heads],
        torch.from_numpy(labels), _nchw(soft),
        lambda lg, lb, ls: tlosses.uvem_loss(lg, lb, ls)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    logits, _ = _logits_labels(9)
    pw = r.uniform(0, 1, labels.size).astype(np.float32)
    want = float(jlosses.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), -1, jnp.asarray(pw)))
    got = float(tlosses.cross_entropy_loss(
        torch.from_numpy(logits).permute(0, 3, 1, 2), torch.from_numpy(labels),
        -1, torch.from_numpy(pw)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_class_balance_weight_matches_jax():
    """Three EMA updates on skewed labels (one class absent, ignore pixels):
    the frequencies, the class weights and every pixel weight to 1e-6
    relative; ignored pixels weigh 0. The update runs the EMA first."""
    r = np.random.default_rng(10)
    js = jbalance.init_class_balance(C, 0.99, 2.0)
    ts = tbalance.init_class_balance(C, 0.99, 2.0, device="cpu")
    for i in range(3):
        lab = r.choice([-1, 0, 1, 1, 2, 3, 3, 3, 5], size=(2, 16, 20)) \
            .astype(np.int32)
        jw, js = jbalance.class_balance_weight(js, jnp.asarray(lab), -1)
        tw, ts = tbalance.class_balance_weight(ts, torch.from_numpy(lab), -1)
        np.testing.assert_allclose(ts.freq.numpy(), np.asarray(js.freq),
                                   rtol=1e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        np.testing.assert_allclose(tbalance.class_weights(ts).numpy(),
                                   np.asarray(jbalance.class_weights(js)),
                                   rtol=1e-6)
        assert (tw.numpy()[lab.reshape(-1) == -1] == 0).all()


def test_prob_dataset_reads_and_augments_as_jax(tmp_path):
    """Soft labels written as (H, W, C) fp16 ``.npy`` beside each image (and
    one as the reference's (C, H, W) ``.pt``) read back equal to the JAX
    package's loader (the port keeps fp16 on the host; JAX casts to f32);
    the stage-3 target pipeline -- ``"compose"`` and the clamp -- crops and
    turns them with the image and the superpixel map exactly as
    ``augment_batch`` does from the same key, and the clamped image matches
    to 1e-5 (a multiply by the f32 reciprocal where JAX divides)."""
    from uemda_tpu.datasets.augment import augment_batch as jax_augment_batch
    from uemda_tpu.datasets.base import SegDataset as JaxSegDataset
    from uemda_tpu.datasets.synthetic import make_synthetic_dataset as jax_make
    from uemda_tpu_torch.datasets.augment import augment_batch
    from uemda_tpu_torch.datasets.base import SegDataset
    from uemda_tpu_torch.datasets.io import read_prob, save_prob

    img_dir, _ = jax_make(str(tmp_path / "data"), IsprsDA, n_train=3, n_val=1,
                          hw=48, seed=4)
    prob_dir = tmp_path / "pseudo"
    prob_dir.mkdir()
    for i in range(3):
        p = _probs(20 + i, b=2, h=48, w=48)[i % 2]
        if i == 2:
            torch.save(torch.from_numpy(p.transpose(2, 0, 1).copy()),
                       str(prob_dir / f"tile_{i:03d}.png.pt"))
        else:
            save_prob(str(prob_dir / f"tile_{i:03d}.png"), p)
    assert read_prob(str(prob_dir / "tile_000.png")).dtype == np.float16
    want = JaxSegDataset(IsprsDA, [img_dir], str(prob_dir), label_type="prob",
                         read_sup=True).batch([0, 1, 2])
    ds = SegDataset(IsprsDA, [img_dir], str(prob_dir), label_type="prob",
                    read_sup=True)
    got = ds.batch([0, 1, 2])
    assert set(got) == set(want) == {"image", "prob", "sup"}
    assert ds.filename(1) == "tile_001.png"
    for k in got:
        np.testing.assert_array_equal(got[k].astype(want[k].dtype), want[k],
                                      err_msg=k)
    mean, std = (100.0, 90.0, 80.0), (30.0, 25.0, 20.0)
    key = jax.random.key(11)
    jout = jax_augment_batch(key, {k: jnp.asarray(v) for k, v in want.items()},
                             (32, 32), mean, std, "compose", clamp=True)
    draws = jax_aug_draws(key, 3, (48, 48), (32, 32), "compose")
    tout = augment_batch({k: torch.from_numpy(v) for k, v in got.items()},
                         (32, 32), mean, std, draws, clamp=True)
    for k in ("prob", "sup"):
        np.testing.assert_array_equal(tout[k].float().numpy(),
                                      np.asarray(jout[k]), err_msg=k)
    image = tout["image"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(image, np.asarray(jout["image"]), atol=1e-5,
                               rtol=0)
    assert image.max() == 1.0 and (image == 1.0).mean() > 0.05


def test_generate_pseudo_labels_matches_jax(tmp_path):
    """The sweep (slide at 32^2 tiles over 48^2 images, 8-view TTA, f32) on
    a tiny model with the same weights: the fp16 probabilities, in memory
    and in the ``.npy`` files, within one fp16 ulp of JAX's (the f32
    probabilities agree to 1e-4, ``test_torch_infer.py``, and the one cast
    to fp16 rounds them; an ulp is 1.2e-4 in [0.25, 0.5)); the colour PNGs
    of the mined labels; the fast path agrees
    with the standard forward, and an odd tile is refused, not run on
    another path."""
    from uemda_tpu.datasets.base import SegDataset as JaxSegDataset
    from uemda_tpu.datasets.synthetic import make_synthetic_dataset as jax_make
    from uemda_tpu.infer.pseudo_gen import generate_pseudo_labels as jax_gen
    from uemda_tpu_torch.datasets.base import SegDataset
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels

    jmodel, variables, tmodel = jax_and_torch_models("resnet18", 32, seed=3)
    img_dir, _ = jax_make(str(tmp_path / "data"), IsprsDA, n_train=3, n_val=1,
                          hw=48, seed=5)
    mean, std = (120.0, 110.0, 100.0), (50.0, 45.0, 40.0)
    kw = dict(tile=(32, 32), tta=True, batch_size=2)
    want = jax_gen(jmodel, variables,
                   JaxSegDataset(IsprsDA, [img_dir], None, label_type="none"),
                   mean, std, out_dir=str(tmp_path / "jax"),
                   compute_dtype="float32", **kw)
    ds = SegDataset(IsprsDA, [img_dir], None, label_type="none")
    got = generate_pseudo_labels(
        tmodel, ds, mean, std, out_dir=str(tmp_path / "port"),
        color_dir=str(tmp_path / "port_color"), compute_dtype=torch.float32,
        device="cpu", **kw)
    assert sorted(got) == sorted(want) == [f"tile_{i:03d}.png"
                                            for i in range(3)]
    def within_one_ulp(a, b):
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
        assert (np.abs(a.astype(np.float32) - b) <= ulp).all()

    for name, arr in got.items():
        assert arr.dtype == np.float16 and arr.shape == (48, 48, C)
        within_one_ulp(arr, want[name])
        within_one_ulp(np.load(tmp_path / "port" / f"{name}.npy"),
                       np.load(tmp_path / "jax" / f"{name}.npy"))
        assert os.path.exists(tmp_path / "port_color" / name)
    fast = generate_pseudo_labels(tmodel, ds, mean, std, fastpath=True,
                                  compute_dtype=torch.float32, device="cpu",
                                  **kw)
    for name, arr in fast.items():
        np.testing.assert_allclose(arr.astype(np.float32),
                                   got[name].astype(np.float32), atol=2e-3)
    with pytest.raises(ValueError, match="even"):
        generate_pseudo_labels(tmodel, ds, mean, std, fastpath=True,
                               tile=(31, 32), device="cpu")

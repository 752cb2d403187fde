"""The stage-1 slice's kernel modules and data path on the CPU: K9 crop +
normalize and the K1 backward (plain versions) against the JAX functions
they replace, the training augmentation against ``augment_batch`` with the
draws derived from the same JAX key, and the shuffled batch stream. The
CUDA kernels against the plain versions are in test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import jax_aug_draws, to_nhwc, to_torch
from uemda_tpu.datasets.augment import augment_batch as jax_augment_batch
from uemda_tpu.datasets.base import infinite_batches as jax_infinite_batches
from uemda_tpu.models.deeplabv2 import instance_norm as jax_instance_norm
from uemda_tpu.ops.pallas_kernels import crop_normalize_pallas
from uemda_tpu_torch.datasets.augment import augment_batch, draw_augment
from uemda_tpu_torch.datasets.base import infinite_batches
from uemda_tpu_torch.ops.crop import crop_normalize, crop_normalize_plain
from uemda_tpu_torch.ops.insnorm import (
    _InstanceNorm,
    instance_norm,
    instance_norm_backward,
    instance_norm_backward_plain,
    instance_norm_forward_plain,
)

MEAN, STD = (97.4603, 86.3828, 92.4078), (36.2062, 35.7308, 35.3348)


def _crop_case(seed, dtype):
    r = np.random.default_rng(seed)
    b, h, w, th, tw = 3, 40, 56, 16, 24
    images = (r.random((b, h, w, 3)) * 255).astype(dtype)
    offsets = np.stack([r.integers(0, h - th + 1, b),
                        r.integers(0, w - tw + 1, b)], 1).astype(np.int32)
    offsets[0] = (h - th, w - tw)  # the last window that fits
    return images, offsets, (th, tw)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_crop_normalize_plain_matches_pallas(dtype):
    """K9's plain version against crop_normalize_pallas in interpret mode,
    uint8 and f32 images; rtol/atol 1e-5 (test_pallas_mine_crop.py:57)."""
    images, offsets, crop = _crop_case(2, dtype)
    want = np.asarray(crop_normalize_pallas(jnp.asarray(images),
                                            jnp.asarray(offsets), crop, MEAN, STD))
    got = crop_normalize(torch.from_numpy(images), torch.from_numpy(offsets),
                         crop, MEAN, STD)
    assert got.dtype == torch.float32 and got.shape == (3, 3) + crop
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        to_nhwc(crop_normalize_plain(torch.from_numpy(images),
                                     torch.from_numpy(offsets), crop, MEAN, STD)),
        to_nhwc(got))


def test_crop_normalize_refuses_windows_outside_the_image():
    images, offsets, crop = _crop_case(3, np.uint8)
    for bad in ((25, 0), (0, 33), (-1, 0)):
        off = offsets.copy()
        off[1] = bad
        with pytest.raises(ValueError, match="outside"):
            crop_normalize(torch.from_numpy(images), torch.from_numpy(off),
                           crop, MEAN, STD)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        crop_normalize(torch.empty(1, 8, 8, 3, dtype=torch.uint8, device="meta"),
                       torch.zeros(1, 2, dtype=torch.int32), (4, 4), MEAN, STD)


def _insnorm_case(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    # high-mean, low-variance channels, as test_torch_kernels.py
    x = r.normal(size=(2, 6, 5, 64)) * 0.5 + r.normal(size=(1, 1, 1, 64)) * 4
    dy = r.normal(size=x.shape)
    return x.astype(np.float32), dy.astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_instance_norm_backward_plain_matches_jax_grad(dtype, tol):
    """The K1 backward's plain version against the cotangent jax.vjp of
    deeplabv2.instance_norm gives, with dy in x's dtype; 1e-5 in f32, 1e-2
    in bf16 (test_pallas_insnorm.py)."""
    x, dy = _insnorm_case(0)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(jax_instance_norm, jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(dy, jdt))[0], np.float32)
    tdt = getattr(torch, dtype)
    xt, dyt = to_torch(x, tdt), to_torch(dy, tdt)
    _, mean, rstd = instance_norm_forward_plain(xt)
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (2, 64)
    got = instance_norm_backward_plain(xt, dyt, mean, rstd)
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), want, atol=tol, rtol=tol)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        to_nhwc(instance_norm_backward(xt, dyt, mean, rstd)), to_nhwc(got))


def test_instance_norm_autograd_on_the_cpu():
    """The autograd function: its backward is the plain backward on the
    forward's statistics, and gradcheck holds in f64."""
    x, dy = _insnorm_case(1)
    xt = to_torch(x).requires_grad_()
    y = instance_norm(xt)
    y.backward(to_torch(dy))
    _, mean, rstd = instance_norm_forward_plain(xt.detach())
    want = instance_norm_backward_plain(xt.detach(), to_torch(dy), mean, rstd)
    np.testing.assert_array_equal(to_nhwc(xt.grad), to_nhwc(want))
    x64 = torch.randn(2, 4, 3, 5, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    x64 = x64.contiguous(memory_format=torch.channels_last).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: _InstanceNorm.apply(t, 1e-5), (x64,))


def _aug_batch(seed, b=3, hw=(40, 48)):
    r = np.random.default_rng(seed)
    image = r.integers(0, 256, (b,) + hw + (3,), dtype=np.uint8)
    label = r.integers(-1, 6, (b,) + hw).astype(np.int32)
    return image, label


@pytest.mark.parametrize("mode", ["oneof", "compose"])
@pytest.mark.parametrize("key", [0, 7, 11])
def test_augment_matches_jax(mode, key):
    """Crop (K9) + D4 against augment_batch with the draws derived from
    the same JAX key: image 1e-6, label exact."""
    image, label = _aug_batch(key)
    crop = (32, 32)
    k = jax.random.key(key)
    want = jax_augment_batch(k, {"image": jnp.asarray(image),
                                 "label": jnp.asarray(label)},
                             crop, MEAN, STD, mode)
    draws = jax_aug_draws(k, 3, image.shape[1:3], crop, mode)
    got = augment_batch({"image": torch.from_numpy(image),
                         "label": torch.from_numpy(label)}, crop, MEAN, STD,
                        draws)
    assert got["image"].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got["image"]), np.asarray(want["image"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))


def test_draw_augment_laws():
    """Draws from a torch.Generator: origins cover every window that fits,
    oneof applies with p = 0.75 over its three ops and k90 in 0..3, compose
    flips each op with p = 0.5; the same seed gives the same draws."""
    def draw(mode, seed=0):
        return draw_augment(torch.Generator().manual_seed(seed), 4000,
                            (40, 48), (32, 32), mode)

    d = draw("oneof")
    assert d.offsets.dtype == torch.int32
    assert set(d.offsets[:, 0].tolist()) == set(range(9))
    assert set(d.offsets[:, 1].tolist()) == set(range(17))
    assert abs(d.d4[:, 0].float().mean().item() - 0.75) < 0.03
    assert set(d.d4[:, 1].tolist()) == {0, 1, 2}
    assert set(d.d4[:, 2].tolist()) == {0, 1, 2, 3}
    c = draw("compose")
    assert np.all(np.abs(c.d4.float().mean(0).numpy() - 0.5) < 0.03)
    assert torch.equal(draw("oneof", 5).d4, draw("oneof", 5).d4)


class _Indices:
    """A dataset whose batches are the indices drawn."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def batch(self, idx):
        return {"idx": np.asarray(idx)}


@pytest.mark.parametrize("n,b,seed,skip", [(10, 4, 0, 0), (7, 8, 3, 2),
                                           (33, 8, 2333, 5)])
def test_infinite_batches_index_order(n, b, seed, skip):
    """The same seed and skip give the JAX package's batch indices (epoch
    reshuffles, drop_last, a batch larger than the split)."""
    ours = infinite_batches(_Indices(n), b, seed=seed, skip_batches=skip)
    theirs = jax_infinite_batches(_Indices(n), b, seed=seed, skip_batches=skip)
    for _ in range(12):
        np.testing.assert_array_equal(next(ours)["idx"], next(theirs)["idx"])

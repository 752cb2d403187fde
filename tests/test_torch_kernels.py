"""The port's kernel modules (K1 instance norm, K2 fused stem + pool, K3 eval
tail): their plain PyTorch versions against the JAX functions and the Pallas
kernels they replace (interpret mode on the CPU). The CUDA kernels against
the plain versions are in test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import to_nhwc, to_torch
from uemda_tpu.models.deeplabv2 import instance_norm as jax_instance_norm
from uemda_tpu.ops.pallas_insnorm import instance_norm_1read
from uemda_tpu.ops.pallas_stem import pack_cw, pack_stem_weight, stem_pool_pallas
from uemda_tpu.ops.pallas_tail import tail_upsample_softmax_mean as jax_tail
from uemda_tpu_torch.ops.insnorm import instance_norm, instance_norm_plain
from uemda_tpu_torch.ops.stem import stem_pool, stem_pool_plain
from uemda_tpu_torch.ops.tail import (
    tail_upsample_softmax_mean,
    tail_upsample_softmax_mean_plain,
)


def _insnorm_input(seed):
    r = np.random.default_rng(seed)
    # high-mean, low-variance channels: E[x^2]-E[x]^2 would cancel
    x = r.normal(size=(2, 8, 8, 256)) * 0.5 + r.normal(size=(1, 1, 1, 256)) * 4
    return x.astype(np.float32)


@pytest.mark.parametrize("ref", ["formula", "pallas"])
def test_instance_norm_plain_f32(ref):
    """f32 against deeplabv2.instance_norm and against instance_norm_1read
    in interpret mode; 1e-5 as test_pallas_insnorm.py:16-18."""
    x = _insnorm_input(0)
    fn = jax_instance_norm if ref == "formula" else instance_norm_1read
    want = np.asarray(fn(jnp.asarray(x)))
    got = to_nhwc(instance_norm_plain(to_torch(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the CPU tensor takes the plain version through the wrapper
    np.testing.assert_array_equal(to_nhwc(instance_norm(to_torch(x))), got)


def test_instance_norm_plain_bf16():
    """bf16 in and out, f32 statistics: within 1e-2 of the JAX kernel."""
    x = _insnorm_input(1)
    want = np.asarray(instance_norm_1read(jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    got = instance_norm_plain(to_torch(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), want, atol=1e-2, rtol=1e-2)


def _stem_input(seed, b=2, h2=32):
    r = np.random.default_rng(seed)
    xs = r.normal(size=(b, h2, h2, 12)).astype(np.float32)
    w4 = (r.normal(size=(4, 4, 12, 64)) * 0.2).astype(np.float32)
    b4 = r.normal(size=(64,)).astype(np.float32)
    return xs, w4, b4


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1.6e-2)])
def test_stem_pool_plain_matches_pallas(dtype, tol):
    """Plain stem (conv pad (2,1), round, bias in dtype, ReLU, 3x3/s2 max
    pool) against stem_pool_pallas in interpret mode at h2 = 32; tolerances
    of test_pallas_stem.py (1e-5 f32, 1.6e-2 bf16 rounding)."""
    xs, w4, b4 = _stem_input(3)
    jdt = jnp.dtype(dtype)
    wp, bp = pack_stem_weight(w4, b4)
    want = np.asarray(stem_pool_pallas(pack_cw(jnp.asarray(xs, jdt)),
                                       jnp.asarray(wp, jdt), jnp.asarray(bp)),
                      np.float32)
    tdt = getattr(torch, dtype)
    got = stem_pool(to_torch(xs, tdt), torch.from_numpy(w4).to(tdt),
                    torch.from_numpy(b4))
    assert got.dtype == tdt and got.shape == (2, 64, 16, 16)
    np.testing.assert_allclose(to_nhwc(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("g,nc,hi,ho", [(2, 6, 8, 64), (2, 7, 16, 48),
                                        (1, 6, 8, 32)])
def test_tail_plain_matches_pallas(g, nc, hi, ho):
    """f32 against tail_upsample_softmax_mean in interpret mode. atol 1e-5:
    F.interpolate sums the taps in another order than the JAX
    interpolation-matrix product. Rows sum to 1."""
    rng = np.random.default_rng(g * 100 + nc * 10 + hi)
    cat = (rng.normal(size=(2, hi, hi, g * nc)) * 3).astype(np.float32)
    want = np.asarray(jax_tail(jnp.asarray(cat), (ho, ho), g, nc))
    got = to_nhwc(tail_upsample_softmax_mean(to_torch(cat), (ho, ho), g, nc))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)

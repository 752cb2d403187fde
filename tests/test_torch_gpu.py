"""The port's CUDA kernels on the card, against their plain versions: the
odd shapes, both dtypes and both instance-norm routes that chip_smoke.py's
serving shapes do not reach, and the card as the entry points' default.

These tests need an NVIDIA GPU and skip without one. They import neither JAX
nor the JAX package, so they run where only PyTorch is installed; the
repository's conftest imports JAX, so on such a machine run::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.ops.insnorm import instance_norm, instance_norm_plain
from uemda_tpu_torch.ops.stem import stem_pool, stem_pool_plain
from uemda_tpu_torch.ops.tail import (
    tail_upsample_softmax_mean,
    tail_upsample_softmax_mean_plain,
)

pytestmark = pytest.mark.gpu
CL = torch.channels_last
# (atol, rtol) per dtype: f32 differs only in summation order; bf16 by one
# rounding of the output (a unit in the last place at |y| < 2 is <= 7.8e-3)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1.6e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False   # the plain f32 side in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dev, dtype, scale=1.0, shift=0.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale + shift
    return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)


def _close(got, ref, dtype):
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 256, 8, 8), (1, 96, 64, 64),
                                   (3, 2048, 32, 32)])
def test_instance_norm_kernel(dev, dtype, shape):
    """Shared-memory slab and, at 64x64 (slab over 200 KB), the route that
    reads global memory again; high-mean channels (two-pass variance)."""
    x = _randn(shape, 1, dev, dtype, shift=3.0).contiguous(memory_format=CL)
    n = instance_norm.launches
    y = instance_norm(x)
    assert instance_norm.launches == n + 1
    assert y.is_contiguous(memory_format=CL)
    _close(y, instance_norm_plain(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw2", [(32, 32), (36, 20), (256, 256), (15, 21)])
def test_stem_pool_kernel(dev, dtype, hw2):
    """Pooled maps that tile evenly and raggedly (18 x 10 pooled pixels
    against 8 x 8 blocks), and odd space-to-depth sides (an input tile even
    but not divisible by 4) pooled to ceil(H2/2)."""
    x = _randn((2, 12) + hw2, 2, dev, dtype).contiguous(memory_format=CL)
    w = _randn((4, 4, 12, 64), 3, dev, dtype, scale=0.2).contiguous()
    b = _randn((64,), 4, dev, torch.float32)
    n = stem_pool.launches
    y = stem_pool(x, w, b)
    assert stem_pool.launches == n + 1
    assert y.shape == (2, 64, (hw2[0] + 1) // 2, (hw2[1] + 1) // 2)
    _close(y, stem_pool_plain(x, w, b), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,nc,hi,ho,wo", [(2, 6, 32, 512, 512),
                                           (1, 7, 16, 48, 40), (2, 6, 8, 1, 9)])
def test_tail_kernel(dev, dtype, g, nc, hi, ho, wo):
    cat = _randn((2, g * nc, hi, hi), 5, dev, dtype, scale=3.0) \
        .contiguous(memory_format=CL)
    n = tail_upsample_softmax_mean.launches
    y = tail_upsample_softmax_mean(cat, (ho, wo), g, nc)
    assert tail_upsample_softmax_mean.launches == n + 1
    ref = tail_upsample_softmax_mean_plain(cat, (ho, wo), g, nc)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 8e-3  # pallas_tail.py:23-24
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol, rtol=0)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = _randn((1, 64, 8, 8), 6, dev, torch.float32)
    with pytest.raises(ValueError, match="channels_last"):
        instance_norm(x.contiguous())
    with pytest.raises(ValueError, match="C % 32"):
        instance_norm(x[:, :48].contiguous(memory_format=CL))
    with pytest.raises(TypeError):
        instance_norm(x.half().contiguous(memory_format=CL))
    with pytest.raises(ValueError, match="at most 16"):
        tail_upsample_softmax_mean(
            _randn((1, 34, 4, 4), 7, dev, torch.float32)
            .contiguous(memory_format=CL), (8, 8), 2, 17)


def test_fastpath_stem_kernel_at_tile_not_divisible_by_4(dev):
    """A 60x60 tile (even, not divisible by 4): the fast path still pools
    its stem in the K2 kernel, and matches the standard eval forward in f32
    (TF32 off) at atol 5e-5, rtol 1e-4."""
    from uemda_tpu_torch.infer.fastpath import build_fastpath

    model = DeeplabV2(DeeplabV2Config.uemda_default(6, resnet_type="resnet18"),
                      generator=torch.Generator().manual_seed(0))
    x = _randn((2, 3, 60, 60), 8, dev, torch.float32) \
        .contiguous(memory_format=CL)
    fast = build_fastpath(model, dtype=torch.float32)
    n = stem_pool.launches
    with torch.no_grad():
        got, ref = fast(x), model(x)
    assert stem_pool.launches == n + 1
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=5e-5, rtol=1e-4)


def test_entry_points_default_to_the_card(dev):
    """device=None is the card; a forward launches K1 and K3 once each."""
    model = DeeplabV2(DeeplabV2Config.uemda_default(6, resnet_type="resnet18"))
    assert next(model.parameters()).is_cuda
    n1, n3 = instance_norm.launches, tail_upsample_softmax_mean.launches
    with torch.no_grad():
        p = model(torch.zeros(1, 3, 64, 64, device=dev))
    torch.cuda.synchronize()
    assert instance_norm.launches == n1 + 1
    assert tail_upsample_softmax_mean.launches == n3 + 1
    np.testing.assert_allclose(p.sum(1).cpu().numpy(), 1.0, atol=1e-5)

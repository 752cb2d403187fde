"""The port's CUDA kernels on the card, against their plain versions: the
odd shapes, both dtypes and both instance-norm routes (forward and
backward, each with pinned clusters that leave a short last CTA) that
chip_smoke.py's shapes do not reach, the crop kernel's vector and element
routes (with and without the clamp), every route of each segment kernel,
the mining kernel in every layout and branch, the fused
bottleneck kernel in both dtypes at odd shapes and dilations, the int8 conv
on the card against the CPU, the fused and int8 fast paths, training
steps that go through the kernels, and the card as the entry points'
default.

These tests need an NVIDIA GPU and skip without one. They import neither JAX
nor the JAX package, so they run where only PyTorch is installed; the
repository's conftest imports JAX, so on such a machine run::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.ops.crop import crop_normalize, crop_normalize_plain
from uemda_tpu_torch.ops.insnorm import (
    instance_norm,
    instance_norm_backward,
    instance_norm_backward_plain,
    instance_norm_backward_plan,
    instance_norm_forward,
    instance_norm_forward_plain,
    instance_norm_forward_plan,
    instance_norm_plain,
)
from uemda_tpu_torch.ops.mine import uvem_mine, uvem_mine_plain, uvem_mine_plan
from uemda_tpu_torch.ops.segment import (
    segment_gather,
    segment_gather_plain,
    segment_max,
    segment_max_plain,
    segment_reduce_plan,
    segment_sum,
    segment_sum_bound,
    segment_sum_plain,
)
from uemda_tpu_torch.ops.stem import stem_pool, stem_pool_plain
from uemda_tpu_torch.ops.tail import (
    tail_plan,
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
    """The K1 forward on its plan, high-mean channels (two-pass variance):
    an 8 x 8 map in one CTA a slab, 64 x 64 split 8 ways, and the flagship
    width."""
    x = _randn(shape, 1, dev, dtype, shift=3.0).contiguous(memory_format=CL)
    n = instance_norm.launches
    y = instance_norm(x)
    assert instance_norm.launches == n + 1
    assert y.is_contiguous(memory_format=CL)
    _close(y, instance_norm_plain(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,route", [
    ((8, 2048, 32, 32), "smem"), ((32, 2048, 32, 32), "smem"),
    ((3, 96, 20, 28), "smem"), ((2, 96, 45, 47), "smem"),
    ((2, 64, 64, 64), "smem"), ((1, 32, 128, 128), None),
    ((1, 32, 192, 192), "global")])
def test_instance_norm_forward_kernel_routes(dev, dtype, shape, route):
    """The K1 forward against its plain version on its plan's route, y at
    f32 1e-5 / bf16 1.6e-2 and the f32 mean and rstd at 1e-5: the flagship
    and the serving batch of 32, an odd shape, a cluster of 8 over 45 x 47
    pixels (the last CTA 5 short), 64 x 64, and 128 x 128 (shared memory in
    bf16, the global route in f32: 8 CTAs' parts overflow it) and 192 x 192
    (global in both); the plan reaches the launcher."""
    x = _randn(shape, 21, dev, dtype, shift=3.0).contiguous(memory_format=CL)
    b, c, h, w = shape
    plan = instance_norm_forward_plan(b, c, h, w, dtype)
    n = instance_norm.launches
    y, mean, rstd = instance_norm_forward(x)
    assert instance_norm.launches == n + 1
    assert instance_norm_forward.plan == plan
    assert plan.route == (route or ("smem" if dtype == torch.bfloat16
                                    else "global"))
    if shape == (2, 96, 45, 47):
        assert plan.cluster == 8 and h * w - 7 * plan.ppc == plan.ppc - 5
    y_ref, mean_ref, rstd_ref = instance_norm_forward_plain(x)
    _close(y, y_ref, dtype)
    for got, ref in ((mean, mean_ref), (rstd, rstd_ref)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("cb", [32, 64])
def test_instance_norm_forward_pinned_clusters(dev, cluster, cb):
    """9 x 7 pixels split 1-8 ways (all but 1 and 3 leave a short last
    CTA) at 32 and 64 channels a CTA, in both dtypes: the pinned plan is
    the one launched, and y, mean and rstd match the plain version."""
    for dtype in (torch.float32, torch.bfloat16):
        x = _randn((2, 64, 9, 7), 22, dev, dtype, shift=3.0) \
            .contiguous(memory_format=CL)
        plan = instance_norm_forward_plan(2, 64, 9, 7, dtype, cb=cb,
                                          cluster=cluster)
        y, mean, rstd = instance_norm_forward(x, plan=plan)
        assert instance_norm_forward.plan == plan
        y_ref, mean_ref, rstd_ref = instance_norm_forward_plain(x)
        _close(y, y_ref, dtype)
        for got, ref in ((mean, mean_ref), (rstd, rstd_ref)):
            np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 2048, 32, 32), (2, 96, 45, 47),
                                   (1, 32, 128, 128)])
def test_instance_norm_forward_statistics_feed_the_backward(dev, dtype,
                                                            shape):
    """The K1 backward on the forward kernel's mean and rstd gives the dx of
    the plain statistics, within the backward's f32 1e-5 / bf16 1e-2."""
    x = _randn(shape, 23, dev, dtype, shift=3.0).contiguous(memory_format=CL)
    dy = _randn(shape, 24, dev, dtype).contiguous(memory_format=CL)
    _, mean, rstd = instance_norm_forward(x)
    _, mean_ref, rstd_ref = instance_norm_forward_plain(x)
    got = instance_norm_backward(x, dy, mean, rstd)
    ref = instance_norm_backward_plain(x, dy, mean_ref, rstd_ref)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw2", [(32, 32), (36, 20), (256, 256), (15, 21),
                                 (66, 34), (97, 130)])
def test_stem_pool_kernel(dev, dtype, hw2):
    """Pooled maps that tile evenly and raggedly (18 x 10 pooled pixels
    against 8 x 8 blocks; 33 x 17 and 49 x 65 against bf16's 16 x 16), and
    odd space-to-depth sides (an input tile even but not divisible by 4, or
    odd) pooled to ceil(H2/2)."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,nc,hi,ho,wo", [
    (32, 2, 6, 32, 512, 512),   # the serving batch of 32
    (2, 2, 7, 7, 45, 37),       # rows of 37 x 7 values, off 16 bytes
    (2, 1, 16, 8, 61, 33),      # 16 classes, the generic instantiation
    (2, 3, 6, 16, 100, 100)])   # three heads
def test_tail_kernel_redesign_shapes(dev, dtype, b, g, nc, hi, ho, wo):
    cat = _randn((b, g * nc, hi, hi), 9, dev, dtype, scale=3.0) \
        .contiguous(memory_format=CL)
    y = tail_upsample_softmax_mean(cat, (ho, wo), g, nc)
    assert tail_upsample_softmax_mean.plan == tail_plan(
        b, hi, hi, ho, wo, g, nc, dtype)
    ref = tail_upsample_softmax_mean_plain(cat, (ho, wo), g, nc)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 8e-3  # pallas_tail.py:23-24
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("rows,cols", [(1, None), (3, None), (16, None),
                                       (2, 100), (5, 7)])
def test_tail_kernel_pinned_plans(dev, rows, cols):
    """Plans pinned to 1-16 rows and column chunks (the last one short) at
    (3, 14, 16, 16) bf16 -> 130 x 250."""
    cat = _randn((3, 14, 16, 16), 10, dev, torch.bfloat16, scale=3.0) \
        .contiguous(memory_format=CL)
    plan = tail_plan(3, 16, 16, 130, 250, 2, 7, torch.bfloat16, rows=rows,
                     cols=cols)
    y = tail_upsample_softmax_mean(cat, (130, 250), 2, 7, plan=plan)
    assert tail_upsample_softmax_mean.plan is plan
    ref = tail_upsample_softmax_mean_plain(cat, (130, 250), 2, 7)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=8e-3, rtol=0)


@pytest.mark.parametrize("hi,b,ho", [(16, 2, 64), (32, 1, 64), (32, 2, 32)])
def test_tail_kernel_refuses_a_plan_of_another_call(dev, hi, b, ho):
    """A plan made for other logits (16 x 16 for 32 x 32, the same output),
    another batch or another output size is refused by the launcher, which
    works out the align_corners scales from the call's own shapes."""
    cat = _randn((2, 12, 32, 32), 11, dev, torch.bfloat16, scale=3.0) \
        .contiguous(memory_format=CL)
    plan = tail_plan(b, hi, hi, ho, 64, 2, 6, torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        tail_upsample_softmax_mean(cat, (64, 64), 2, 6, plan=plan)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = _randn((1, 64, 8, 8), 6, dev, torch.float32)
    with pytest.raises(ValueError, match="channels_last"):
        instance_norm(x.contiguous())
    with pytest.raises(ValueError, match="C % 32"):
        instance_norm(x[:, :48].contiguous(memory_format=CL))
    with pytest.raises(TypeError):
        instance_norm(x.half().contiguous(memory_format=CL))
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(1, 8, 8, 64) \
        .permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        instance_norm(shifted)
    bad = instance_norm_forward_plan(1, 64, 8, 8, torch.float32, cluster=2)
    bad = dataclasses.replace(bad, ppc=bad.ppc + 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        instance_norm_forward(x.contiguous(memory_format=CL), plan=bad)
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


MEAN, STD = (73.53, 80.02, 74.59), (41.51, 35.67, 33.76)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("case", [
    ((2, 100, 90), (40, 36), [(0, 0), (60, 54)]),      # origin and the last fit
    ((3, 64, 64), (64, 64), [(0, 0)] * 3),              # the whole image
    ((2, 96, 96), (32, 32), [(16, 16), (7, 13)]),       # 16-byte and odd rows
])
def test_crop_normalize_kernel(dev, dtype, case):
    """K9 against its plain version; exact in f32 (one subtract and one
    multiply by the same f32 reciprocal on both sides)."""
    (b, h, w), crop, offs = case
    r = np.random.default_rng(9)
    img = r.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    x = torch.from_numpy(img).to(dev, dtype)
    off = torch.tensor(offs, dtype=torch.int32)
    n = crop_normalize.launches
    got = crop_normalize(x, off, crop, MEAN, STD)
    assert crop_normalize.launches == n + 1
    assert got.shape == (b, 3) + crop and got.is_contiguous(memory_format=CL)
    ref = crop_normalize_plain(x, off, crop, MEAN, STD)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 256, 8, 8), (1, 96, 64, 64),
                                   (3, 2048, 32, 32), (2, 64, 9, 7),
                                   (2, 96, 45, 47), (1, 32, 128, 128)])
def test_instance_norm_backward_kernel(dev, dtype, shape):
    """The K1 backward against its plain version on the forward kernel's
    statistics (which match the plain statistics to 1e-5), on the plan's
    route: shared memory up to 64 x 64 in both dtypes (f32 at 32 x 32
    among them), a cluster of 8 over 45 x 47 pixels that leaves the last
    CTA 5 short, the global route at 128 x 128 (8 CTAs' parts overflow
    shared memory); and at 9 x 7 with the cluster pinned to 1-8, each split
    but 1 leaving a short last CTA. f32 1e-5, bf16 1e-2
    (test_pallas_insnorm.py)."""
    x = _randn(shape, 11, dev, dtype, shift=3.0).contiguous(memory_format=CL)
    dy = _randn(shape, 12, dev, dtype).contiguous(memory_format=CL)
    y, mean, rstd = instance_norm_forward(x)
    y_ref, mean_ref, rstd_ref = instance_norm_forward_plain(x)
    _close(y, y_ref, dtype)
    for got, ref in ((mean, mean_ref), (rstd, rstd_ref)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    b, c, h, w = shape
    plans = [None]
    if shape == (2, 64, 9, 7):
        plans += [instance_norm_backward_plan(b, c, h, w, dtype, cluster=k)
                  for k in (1, 2, 4, 8)]
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    ref = instance_norm_backward_plain(x, dy, mean, rstd)
    for plan in plans:
        n = instance_norm_backward.launches
        dx = instance_norm_backward(x, dy, mean, rstd, plan=plan)
        assert instance_norm_backward.launches == n + 1
        assert dx.is_contiguous(memory_format=CL)
        p = instance_norm_backward.plan
        assert p.route == ("global" if shape == (1, 32, 128, 128) else "smem")
        if shape == (2, 96, 45, 47):
            assert p.cluster == 8 and h * w - 7 * p.ppc == p.ppc - 5
        torch.cuda.synchronize()
        np.testing.assert_allclose(dx.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), atol=tol,
                                   rtol=tol)


def test_instance_norm_autograd_launches_both_kernels(dev):
    x = _randn((2, 64, 8, 8), 13, dev, torch.float32) \
        .contiguous(memory_format=CL).requires_grad_()
    dy = _randn((2, 64, 8, 8), 14, dev, torch.float32).contiguous(memory_format=CL)
    n1, n2 = instance_norm.launches, instance_norm_backward.launches
    instance_norm(x).backward(dy)
    assert (instance_norm.launches, instance_norm_backward.launches) == (n1 + 1, n2 + 1)
    _, mean, rstd = instance_norm_forward_plain(x.detach())
    ref = instance_norm_backward_plain(x.detach(), dy, mean, rstd)
    torch.cuda.synchronize()
    np.testing.assert_allclose(x.grad.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)


def test_train_and_crop_kernels_refuse_what_they_do_not_take(dev):
    x = _randn((1, 64, 8, 8), 15, dev, torch.float32).contiguous(memory_format=CL)
    _, mean, rstd = instance_norm_forward(x)
    with pytest.raises(ValueError, match="does not match"):
        instance_norm_backward(x, x.bfloat16(), mean, rstd)
    with pytest.raises(ValueError, match="channels_last"):
        instance_norm_backward(x, x.contiguous(), mean, rstd)
    with pytest.raises(ValueError, match="C % 32"):
        xs = x[:, :48].contiguous(memory_format=CL)
        instance_norm_backward(xs, xs, mean[:, :48], rstd[:, :48])
    with pytest.raises(ValueError, match="is not"):
        instance_norm_backward(x, x, mean[:, :32].contiguous(), rstd)
    shifted = torch.empty(mean.numel() + 1, device=dev)[1:].view_as(mean)
    shifted.copy_(mean)
    with pytest.raises(ValueError, match="16-byte aligned"):
        instance_norm_backward(x, x, shifted, rstd)
    img = torch.zeros(2, 16, 16, 3, dtype=torch.uint8, device=dev)
    off = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        crop_normalize(img.half(), off, (8, 8), MEAN, STD)
    with pytest.raises(ValueError, match="outside"):
        crop_normalize(img, torch.tensor([[0, 0], [9, 0]]), (8, 8), MEAN, STD)
    with pytest.raises(ValueError, match="contiguous"):
        crop_normalize(img.transpose(1, 2), off, (8, 8), MEAN, STD)
    with pytest.raises(ValueError, match="3"):
        crop_normalize(img[..., :2].contiguous(), off, (8, 8), MEAN, STD)


def test_train_step_goes_through_the_kernels(dev):
    """One bf16 stage-1 step with CORAL on a CUDA resnet18 model launches
    K9 (two crops), the K1 forward (two forwards) and the K1 backward, and
    gives finite losses."""
    import dataclasses

    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.train.loop import build_model, build_state, default_hparams
    from uemda_tpu_torch.train.steps import make_src_step

    cfg = dataclasses.replace(PRESETS["2urban"], model="resnet18", crop=(64, 64))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    state = build_state(model, cfg, 10)
    step = make_src_step(model, default_hparams(cfg, align_domain=True))
    r = np.random.default_rng(0)
    bs = {"image": torch.from_numpy(r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8)).to(dev),
          "label": torch.from_numpy(r.integers(-1, 7, (2, 80, 80)).astype(np.int32)).to(dev)}
    bt = {"image": torch.from_numpy(r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8)).to(dev)}
    fns = (crop_normalize, instance_norm, instance_norm_backward)
    before = [fn.launches for fn in fns]
    metrics = step(state, bs, bt, 0)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(fns, before)] == [2, 2, 2]
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.step == 1


def _grid_sup(b, h, w, cell, seed):
    """Grid superpixel ids over a (b, h, w) batch with a one-pixel boundary
    ring carrying the max id, as datasets/synthetic.py draws them, each
    sample shifted so the maps differ."""
    gy, gx = -(-h // cell), -(-w // cell)
    n = gy * gx
    r = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        ys = (np.arange(h) + r.integers(0, cell)) // cell % gy
        xs = (np.arange(w) + r.integers(0, cell)) // cell % gx
        sup = ys[:, None] * gx + xs[None, :]
        ring = np.zeros((h, w), bool)
        ring[::cell] = True
        ring[:, ::cell] = True
        out.append(np.where(ring, n, sup))
    return np.stack(out), n + 1


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", [
    # (B, H, W, C, cell, extra segments): shared-memory table ...
    (2, 64, 96, 7, 16, 0),
    (3, 33, 47, 6, 5, 3),          # odd sizes, empty segments at the top
    (1, 40, 40, 11, 8, 0),         # C > 8: two channel passes
    (2, 17, 15, 1, 4, 0),          # C = 1; 255 pixels: one short K7 CTA
    (3, 31, 29, 16, 6, 2),         # C = 16: K7's two lanes a pixel
    # ... and S x C over the 227 KB of shared memory: a window of the table
    (2, 128, 128, 7, 2, 5000),
])
def test_segment_kernels(dev, ids_dtype, case):
    """K5 and K7 exact against their plain versions; K6 exact on one-hot
    counts and, on random values, within the error bound of f32 summation
    in any order of the exact sums (its atomics' order varies); out-of-range
    ids (>= S, and negative) left out of both reductions and gathered back
    as NaN. K7's pixel counts are not multiples of its CTA's 256 (128 at C
    = 11 and 16) but at 64 x 96 and 128 x 128."""
    b, h, w, c, cell, extra = case
    sup, s = _grid_sup(b, h, w, cell, seed=c)
    s += extra
    sup[0, 0, :3] = [s, s + 7, -2]           # out of range
    ids = torch.from_numpy(sup.reshape(b, -1)).to(dev, ids_dtype)
    r = np.random.default_rng(h)
    val = torch.from_numpy(r.normal(size=(b, h * w, c)).astype(np.float32)).to(dev)
    n5, n6, n7 = segment_max.launches, segment_sum.launches, segment_gather.launches
    got = segment_max(val, ids, s)
    assert segment_max.route == ("window" if extra > 1000 else "full")
    assert segment_max.plan == segment_reduce_plan(b, h * w, c, s, ids_dtype)
    ref = segment_max_plain(val, ids, s)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if extra:  # the segments past the map's ids are empty: -inf
        assert torch.isinf(got[:, -extra:]).all()
    oh = torch.nn.functional.one_hot(
        torch.from_numpy(r.integers(0, c, (b, h * w))), c).float().to(dev)
    assert torch.equal(segment_sum(oh, ids, s), segment_sum_plain(oh, ids, s))
    got_s = segment_sum(val, ids, s)
    exact, bound = segment_sum_bound(val, ids, s)
    torch.cuda.synchronize()
    assert bool(((got_s.double() - exact).abs() <= bound).all())
    g = segment_gather(got, ids)
    gref = segment_gather_plain(ref, ids)
    torch.cuda.synchronize()
    assert segment_gather.plan.route == "staged"
    assert torch.equal(torch.nan_to_num(g, nan=7.0),
                       torch.nan_to_num(gref, nan=7.0))
    assert torch.isnan(g[0, :3]).all() and not torch.isnan(g[0, 3:]).any()
    assert (segment_max.launches, segment_sum.launches,
            segment_gather.launches) == (n5 + 1, n6 + 2, n7 + 1)


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_segment_gather_kernel_wide_rows(dev, ids_dtype):
    """K7's direct route (rows wider than 2048 floats, one pixel a CTA)
    and the widest staged row, exact, NaN for ids outside [0, S)."""
    r = np.random.default_rng(5)
    for c, route in ((2500, "direct"), (2048, "staged")):
        seg = torch.from_numpy(r.normal(size=(2, 9, c)).astype(np.float32)).to(dev)
        ids_np = r.integers(0, 9, (2, 37))
        ids_np[1, [0, 5, 36]] = [-1, 9, 1 << 20]
        ids = torch.from_numpy(ids_np).to(dev, ids_dtype)
        got = segment_gather(seg, ids)
        assert segment_gather.plan.route == route
        ref = segment_gather_plain(seg, ids)
        torch.cuda.synchronize()
        assert torch.equal(torch.nan_to_num(got, nan=7.0),
                           torch.nan_to_num(ref, nan=7.0))
        assert torch.isnan(got[1, [0, 5, 36]]).all()
        assert not torch.isnan(got[0]).any()


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["random window", "random full", "global",
                                  "isprs", "coherent tile 512"])
def test_segment_reduce_routes(dev, ids_dtype, case):
    """K5 and K6 on each route, equal to their plain versions (K6: one-hot
    counts exact, random sums within the f32 summation bound), with ids out
    of range: random ids that no window holds (every tile to the output's
    atomics), the same on a pinned full table, the pinned global route,
    ISPRS's 6 classes, and a pinned tile of 512 pixels; the plan reaches
    the launcher."""
    b, h, w, s = 2, 96, 128, 1000
    c = 6 if case == "isprs" else 7
    sup, _ = _grid_sup(b, h, w, 4, seed=3)  # 24 x 32 cells, top id 768
    r = np.random.default_rng(31)
    if case.startswith("random"):
        sup = r.integers(0, s, (b, h, w))
    sup[1, 0, :3] = [s, s + 9, -1]
    ids = torch.from_numpy(sup.reshape(b, -1)).to(dev, ids_dtype)
    pin = {"random full": dict(route="full"), "global": dict(route="global"),
           "coherent tile 512": dict(tile=512)}.get(case)
    plan = segment_reduce_plan(b, h * w, c, s, ids_dtype, **(pin or {}))
    assert plan.route == {"random full": "full", "global": "global"}.get(
        case, "window")
    val = torch.from_numpy(r.normal(size=(b, h * w, c)).astype(np.float32)).to(dev)
    got = segment_max(val, ids, s, plan=plan if pin else None)
    assert segment_max.plan == plan
    assert torch.equal(got, segment_max_plain(val, ids, s))
    oh = torch.nn.functional.one_hot(
        torch.from_numpy(r.integers(0, c, (b, h * w))), c).float().to(dev)
    assert torch.equal(segment_sum(oh, ids, s, plan=plan if pin else None),
                       segment_sum_plain(oh, ids, s))
    got_s = segment_sum(val, ids, s, plan=plan if pin else None)
    assert segment_sum.plan == plan
    exact, bound = segment_sum_bound(val, ids, s)
    torch.cuda.synchronize()
    assert bool(((got_s.double() - exact).abs() <= bound).all())


def test_segment_kernels_refuse_what_they_do_not_take(dev):
    val = torch.zeros(2, 16, 7, device=dev)
    ids = torch.zeros(2, 16, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        segment_max(val.bfloat16(), ids, 4)
    with pytest.raises(TypeError):
        segment_sum(val, ids.float(), 4)
    with pytest.raises(ValueError, match="do not match"):
        segment_max(val, ids[:, :8].contiguous(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        segment_max(val.transpose(0, 1).contiguous().transpose(0, 1), ids, 4)
    with pytest.raises(ValueError, match="do not match"):
        segment_gather(val, ids[:1])
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        segment_gather(val, ids.cpu())
    bad = segment_reduce_plan(2, 16, 7, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        segment_max(val, ids, 4, plan=dataclasses.replace(bad, rows=3))


def test_align_step_goes_through_the_kernels(dev):
    """One bf16 stage-2 step (CORAL, refine mode 'all') on a CUDA resnet18
    model launches K5 and K7 once each, K9 twice, the K1 forward twice and
    its backward twice, and gives finite losses; init_prototypes' step
    launches the K1 forward once and leaves the BatchNorm buffers alone."""
    import dataclasses

    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.train.loop import build_model, build_state, default_hparams
    from uemda_tpu_torch.train.steps import make_align_step, make_init_proto_step

    cfg = dataclasses.replace(PRESETS["2urban"], model="resnet18", crop=(64, 64))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    sup, _ = _grid_sup(2, 80, 80, 16, seed=1)
    bs = {"image": torch.from_numpy(r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8)).to(dev),
          "label": torch.from_numpy(r.integers(-1, 7, (2, 80, 80)).astype(np.int32)).to(dev)}
    bt = {"image": torch.from_numpy(r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8)).to(dev),
          "sup": torch.from_numpy(sup.astype(np.int32)).to(dev)}
    hp = default_hparams(cfg, align_domain=True)
    state = build_state(model, cfg, 10)
    buffers = {n: t.clone() for n, t in model.named_buffers()}
    n1 = instance_norm.launches
    make_init_proto_step(model, hp)(state, {k: bs[k] for k in ("image", "label")}, 0)
    torch.cuda.synchronize()
    assert instance_norm.launches == n1 + 1
    assert all(torch.equal(t, buffers[n]) for n, t in model.named_buffers())
    assert float(state.aligner.data_cnt.sum()) >= 0
    fns = (segment_max, segment_gather, crop_normalize, instance_norm,
           instance_norm_backward)
    before = [fn.launches for fn in fns]
    metrics = make_align_step(model, hp)(state, bs, bt, 0)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(fns, before)] == [1, 1, 2, 2, 2]
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.step == 1


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("case", [
    ((2, 100, 90), (40, 36), [(0, 0), (60, 54)]),
    ((2, 96, 96), (32, 32), [(16, 16), (7, 13)]),
])
def test_crop_normalize_clamp_kernel(dev, dtype, case):
    """K9 with the stage-3 clamp against its plain version, exactly, on
    means and deviations that push about half the values past 1.0."""
    (b, h, w), crop, offs = case
    r = np.random.default_rng(21)
    x = torch.from_numpy(r.integers(0, 256, (b, h, w, 3)).astype(np.uint8)) \
        .to(dev, dtype)
    off = torch.tensor(offs, dtype=torch.int32)
    mean, std = (100.0, 90.0, 80.0), (30.0, 25.0, 20.0)
    n = crop_normalize.launches
    got = crop_normalize(x, off, crop, mean, std, clamp=True)
    assert crop_normalize.launches == n + 1
    ref = crop_normalize_plain(x, off, crop, mean, std, clamp=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert float(got.max()) == 1.0 and float((got == 1.0).float().mean()) > 0.2


def _mine_inputs(shape, seed, dev):
    """Soft labels whose entropies fall in all three UVEM branches and
    whose selection gives one class, none and several; exact zeros."""
    b, c, h, w = shape
    r = np.random.default_rng(seed)
    scale = r.choice([0.3, 2.0, 8.0], size=(b, 1, h, w))
    logit = r.normal(size=shape) * scale
    p = np.exp(logit - logit.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[0, :, 0, 0] = np.eye(c)[0]
    return torch.from_numpy(p.astype(np.float32)).to(dev)


def _mine_close(got, ref):
    """Labels equal; u rtol 1e-6 / atol 1e-7 and w rtol 1e-5 / atol 1e-7
    (tests/test_pallas_mine_crop.py:26-28), NaN where the other is NaN."""
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    for a, b, rtol in ((got[2], ref[2], 1e-6), (got[1], ref[1], 1e-5)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "rot90", "fp16"])
@pytest.mark.parametrize("shape", [(2, 6, 37, 53), (3, 7, 64, 64),
                                   (1, 19, 9, 300)])
def test_uvem_mine_kernel(dev, layout, shape):
    """K8 against its plain version: contiguous planes, channels_last
    memory, a rotated view (read through its strides, no copy) and fp16
    input (cast to f32 first); odd sizes and more classes."""
    p = _mine_inputs(shape, 31, dev)
    if layout == "channels_last":
        p = p.contiguous(memory_format=CL)
    elif layout == "rot90":
        p = torch.rot90(p.contiguous(memory_format=CL), 1, (2, 3))
    elif layout == "fp16":
        p = p.half()
    n = uvem_mine.launches
    got = uvem_mine(p, 0.8, 0.6, 0.2, 0.7, 4.0)
    assert uvem_mine.launches == n + 1
    assert [t.dtype for t in got] == [torch.int32, torch.float32, torch.float32]
    ref = uvem_mine_plain(p, 0.8, 0.6, 0.2, 0.7, 4.0)
    _mine_close(got, ref)
    lab = got[0].cpu()
    assert (lab == -1).any() and (lab >= 0).any()


@pytest.mark.parametrize("m,t", [(0.2, 0.7), (0.0, 0.5), (0.6, 0.5)])
def test_uvem_mine_kernel_branches_and_nan(dev, m, t):
    """The degenerate (m, t) pairs and a NaN probability: its pixel's u is
    NaN with the right branch's weight, and no pixel of that sample selects
    its class (the class max is NaN)."""
    p = _mine_inputs((2, 7, 40, 48), 32, dev)
    p[1, 3, 5, 6] = float("nan")
    got = uvem_mine(p, 0.8, 0.6, m, t, 4.0)
    _mine_close(got, uvem_mine_plain(p, 0.8, 0.6, m, t, 4.0))
    assert torch.isnan(got[2][1, 5, 6]) and not (got[0][1] == 3).any()


@pytest.mark.parametrize("case,route", [
    ("channels_last", "channels_last"), ("nchw", "nchw"),
    ("hw % 4", "strided"), ("misaligned", "strided"), ("C 19", "strided")])
def test_uvem_mine_kernel_routes(dev, case, route):
    """One case per route of uvem_mine_plan: 16-byte loads of channels_last
    memory and of NCHW planes; through the strides for H*W not a multiple
    of 4, for a base one pixel (7 floats) into a buffer, and for 19
    classes."""
    shape = {"hw % 4": (2, 7, 37, 53), "C 19": (1, 19, 9, 300)}.get(
        case, (2, 7, 40, 48))
    p = _mine_inputs(shape, 35, dev)
    if case in ("channels_last", "misaligned"):
        p = p.contiguous(memory_format=CL)
    if case == "misaligned":
        flat = torch.empty(p.numel() + 7, device=dev)
        flat[7:].copy_(p.permute(0, 2, 3, 1).reshape(-1))
        p = flat[7:].view(2, 40, 48, 7).permute(0, 3, 1, 2)
    got = uvem_mine(p, 0.8, 0.6, 0.2, 0.7, 4.0)
    assert uvem_mine.plan.route == route
    _mine_close(got, uvem_mine_plain(p, 0.8, 0.6, 0.2, 0.7, 4.0))


@pytest.mark.parametrize("ppt", [4, 8, 16])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_uvem_mine_kernel_pinned_ppt(dev, ppt, layout):
    """4-16 pixels a thread: the labels, w and u do not change (a sample's
    thresholds are reduced from every CTA's maxima before any label;
    cutoffs 0.4 / 0.3 leave pixels with several candidates, whose
    probabilities pass 2 reads again)."""
    p = _mine_inputs((3, 7, 64, 80), 36, dev)
    p[2, 4, 9, 9] = float("nan")
    if layout == "channels_last":
        p = p.contiguous(memory_format=CL)
    plan = uvem_mine_plan(3, 7, 64, 80, p.stride(), p.data_ptr(), ppt=ppt)
    assert plan.route == layout
    got = uvem_mine(p, 0.4, 0.3, 0.2, 0.7, 4.0, plan=plan)
    assert uvem_mine.plan is plan
    _mine_close(got, uvem_mine_plain(p, 0.4, 0.3, 0.2, 0.7, 4.0))


def test_uvem_mine_refuses_what_it_does_not_take(dev):
    p = _mine_inputs((1, 6, 8, 8), 33, dev)
    with pytest.raises(TypeError):
        uvem_mine(p.double())
    with pytest.raises(ValueError, match="4 dims"):
        uvem_mine(p[0])
    with pytest.raises(ValueError, match="empty"):
        uvem_mine(p[:, :, :0])


def test_ssl_step_goes_through_the_kernels(dev):
    """One bf16 stage-3 step (UVEM, refine 'all', the ISPRS clamp) on a
    CUDA resnet18 model launches K8 once, K5 and K7 once each, K9 twice and
    the K1 forward and backward twice each, with finite losses."""
    import dataclasses

    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.train.loop import build_model, build_state, default_hparams
    from uemda_tpu_torch.train.steps import make_ssl_step

    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                              crop=(64, 64))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    r = np.random.default_rng(1)
    sup, _ = _grid_sup(2, 80, 80, 16, seed=2)
    prob = _mine_inputs((2, 6, 80, 80), 34, "cpu").permute(0, 2, 3, 1)
    bs = {"image": torch.from_numpy(r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8)).to(dev),
          "label": torch.from_numpy(r.integers(-1, 6, (2, 80, 80)).astype(np.int32)).to(dev)}
    bt = {"image": torch.from_numpy(r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8)).to(dev),
          "sup": torch.from_numpy(sup.astype(np.int32)).to(dev),
          "prob": prob.contiguous().half().to(dev)}
    hp = default_hparams(cfg, balance_source=True, balance_target=True)
    assert hp.clamp_target
    state = build_state(model, cfg, 10, prototypes=torch.randn(6, 512))
    fns = (uvem_mine, segment_max, segment_gather, crop_normalize,
           instance_norm, instance_norm_backward)
    before = [fn.launches for fn in fns]
    metrics = make_ssl_step(model, hp)(state, bs, bt, 0)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(fns, before)] == [1, 1, 1, 2, 2, 2]
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.step == 1


def _block_args(shape, cmid, dtype, seed, dev):
    """x (B, C, H, W) channels_last and a block's folded weights (OIHW,
    channels_last) at He scale, the residual branch at half the identity's
    scale, as in a trained ResNet; f32 biases."""
    b, c, h, w = shape
    r = np.random.default_rng(seed)

    def t(a, dt):
        v = torch.from_numpy(a.astype(np.float32)).to(dev, dt)
        return v.contiguous(memory_format=CL) if v.dim() == 4 else v

    return (t(r.normal(size=shape), dtype),
            t(r.normal(size=(cmid, c, 1, 1)) / np.sqrt(c), dtype),
            t(r.normal(size=(cmid,)) * 0.1, torch.float32),
            t(r.normal(size=(cmid, cmid, 3, 3)) / np.sqrt(9 * cmid), dtype),
            t(r.normal(size=(cmid,)) * 0.1, torch.float32),
            t(r.normal(size=(c, cmid, 1, 1)) * 0.5 / np.sqrt(cmid), dtype),
            t(r.normal(size=(c,)) * 0.1, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cmid,dil", [
    ((2, 64, 37, 53), 16, 1), ((2, 64, 37, 53), 16, 2), ((2, 256, 20, 24), 64, 1),
    ((8, 256, 96, 96), 64, 1), ((1, 512, 6, 6), 128, 2), ((1, 2048, 6, 6), 512, 2),
    ((1, 1024, 9, 7), 256, 4), ((3, 256, 24, 40), 64, 1),
    ((1, 2048, 32, 32), 512, 2), ((1, 2048, 5, 7), 512, 2),
    ((1, 64, 5, 7), 1024, 1)])
def test_bottleneck_identity_kernel(dev, dtype, shape, cmid, dil):
    """K4 against its plain version: sides that are not multiples of a tile,
    dilations 1, 2 and 4 (a dilation-2 tile on a 6x6 map is all edge), the
    flagship's widths, a grid of 288 blocks; for the wgmma design, a grid of
    27 tiles (odd), B = 1 with 16 tiles (fewer than the SMs), layer4's width
    at dilation 2 on a 5x7 map (smaller than one tile), and Cm 1024 (conv2 in
    two passes, y2 beside y1); f32 on the CUDA cores at 1e-5, bf16 at
    1.6e-2 (the 3x3's tap order, one bf16 rounding)."""
    from uemda_tpu_torch.ops.resblock import (
        bottleneck_identity,
        bottleneck_identity_plain,
    )

    args = _block_args(shape, cmid, dtype, 40 + dil, dev)
    n = bottleneck_identity.launches
    got = bottleneck_identity(*args, dilation=dil)
    assert bottleneck_identity.launches == n + 1
    assert got.is_contiguous(memory_format=CL)
    _close(got, bottleneck_identity_plain(*args, dilation=dil), dtype)


def test_bottleneck_identity_refuses_what_it_does_not_take(dev):
    from uemda_tpu_torch.ops.resblock import bottleneck_identity

    x, w1, b1, w2, b2, w3, b3 = _block_args((1, 64, 8, 8), 16, torch.bfloat16,
                                            1, dev)
    with pytest.raises(TypeError):
        bottleneck_identity(x, w1.float(), b1, w2, b2, w3, b3)
    with pytest.raises(ValueError, match="channels_last"):
        bottleneck_identity(x.contiguous(), w1, b1, w2, b2, w3, b3)
    with pytest.raises(ValueError, match="multiples of 16"):
        bottleneck_identity(x, w1[:8], b1[:8],
                            w2[:8, :8].contiguous(memory_format=CL), b2[:8],
                            w3[:, :8].contiguous(memory_format=CL), b3)
    with pytest.raises(ValueError, match="Cin == Cout"):
        bottleneck_identity(x, w1, b1, w2, b2, w3[:32], b3[:32])


@pytest.mark.parametrize("stride,dilation,static", [
    (1, 1, False), (2, 1, False), (1, 2, True)])
def test_conv_int8_on_the_card_equals_the_cpu(dev, stride, dilation, static):
    """The int8 conv (cuBLASLt's int8 GEMM through torch._int_mm) on the
    card against the same call on the CPU: int32 sums are exact, so equal;
    also a 1x1 with N = 6 and M = 8 rows (padded for the card)."""
    from uemda_tpu_torch.infer.fastpath import _conv_int8, _quantize_w

    r = np.random.default_rng(5)
    x = torch.from_numpy(r.normal(size=(2, 64, 19, 23)).astype(np.float32))
    wq, s = _quantize_w(r.normal(size=(96, 64, 3, 3)).astype(np.float32) * 0.1)
    b = torch.from_numpy(r.normal(size=(96,)).astype(np.float32))
    a = torch.tensor(2.0 / 127.0) if static else None
    args = (torch.from_numpy(wq), torch.from_numpy(s), b)
    cpu = _conv_int8(x.contiguous(memory_format=CL), *args, stride=stride,
                     dilation=dilation, a=a)
    gpu = _conv_int8(x.to(dev).contiguous(memory_format=CL),
                     *(t.to(dev) for t in args), stride=stride,
                     dilation=dilation, a=None if a is None else a.to(dev))
    assert torch.equal(gpu.cpu(), cpu)
    wq1, s1 = _quantize_w(r.normal(size=(6, 64, 1, 1)).astype(np.float32))
    x1 = x[:, :, :2, :2].contiguous(memory_format=CL)
    args1 = (torch.from_numpy(wq1), torch.from_numpy(s1), b[:6])
    assert torch.equal(_conv_int8(x1.to(dev), *(t.to(dev) for t in args1)).cpu(),
                       _conv_int8(x1, *args1))


def test_fused_and_int8_fastpaths(dev):
    """ResNet-50 OS16 at 64x64: fused_stages (1, 2) and (1, 2, 3, 4) launch
    K4 5 and 12 times a forward and match the unfused fast path in f32 (TF32
    off) at atol 5e-5, rtol 1e-4; the bf16 int8 fast path (dynamic, and
    calibrated on every stage) and Int8Model on the f32 model give finite
    probabilities that sum to 1 within 2e-2."""
    from uemda_tpu_torch.infer.fastpath import build_fastpath
    from uemda_tpu_torch.infer.quant import Int8Model
    from uemda_tpu_torch.ops.resblock import bottleneck_identity

    model = DeeplabV2(DeeplabV2Config.uemda_default(6),
                      generator=torch.Generator().manual_seed(0))
    x = _randn((2, 3, 64, 64), 9, dev, torch.float32) \
        .contiguous(memory_format=CL)
    with torch.no_grad():
        ref = build_fastpath(model, dtype=torch.float32)(x)
        for stages, n_k4 in (((1, 2), 5), ((1, 2, 3, 4), 12)):
            fast = build_fastpath(model, dtype=torch.float32,
                                  fused_stages=stages)
            n = bottleneck_identity.launches
            got = fast(x)
            assert bottleneck_identity.launches == n + n_k4
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                       atol=5e-5, rtol=1e-4)
        xb = x.to(torch.bfloat16)
        for fast, xin in (
                (build_fastpath(model, dtype=torch.bfloat16, int8=True), xb),
                (build_fastpath(model, dtype=torch.bfloat16, int8=True,
                                int8_stages=(1, 2, 3, 4),
                                calibration_batches=[x, x * 0.5]), xb),
                (Int8Model(model), x)):
            p = fast(xin)
            torch.cuda.synchronize()
            assert torch.isfinite(p.float()).all()
            np.testing.assert_allclose(p.float().sum(1).cpu().numpy(), 1.0,
                                       atol=2e-2)

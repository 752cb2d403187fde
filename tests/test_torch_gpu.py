"""The port's CUDA kernels on the card, against their plain versions: the
odd shapes, both dtypes and both instance-norm routes (forward and
backward, each with pinned clusters that leave a short last CTA) that
chip_smoke.py's shapes do not reach, the crop kernel's vector and element
routes (with and without the clamp), every route of each segment kernel,
the mining kernel in every layout and branch, the fused
bottleneck kernel in both dtypes at odd shapes and dilations, the int8 conv
on the card against the CPU, the fused and int8 fast paths, training
steps that go through the kernels (the adversarial and DCA steps eager
against their CUDA-graph replays), TransNorm and the discriminator in
bf16 against f32, the eval BatchNorm epilogue (``bnact``) against its plain
version and the standard forward on it against the library's calls, the
captured serving predictor against eager calls (and
its pool, and a capture that fails), ``sample_features`` on the card
against the CPU, ``slide_predict`` against an eager predictor, the trace
reader on a CUDA trace, and the card as the entry points' default.

These tests need an NVIDIA GPU and skip without one. They import neither JAX
nor the JAX package, so they run where only PyTorch is installed; the
repository's conftest imports JAX, so on such a machine run::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import collections
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


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_crop_normalize_kernel_device_origins(dev, dtype):
    """K9 reading its origins from a (B, 2) int32 tensor on the card equals
    its plain version on the host's origins, exactly; a window outside the
    image that reaches the kernel unchecked gives NaN rows, not a fault."""
    r = np.random.default_rng(11)
    img = torch.from_numpy(r.integers(0, 256, (4, 90, 100, 3)).astype(np.uint8))
    x = img.to(dev, dtype)
    off = torch.tensor([[0, 0], [58, 68], [7, 13], [31, 2]], dtype=torch.int32)
    n = crop_normalize.launches
    got = crop_normalize(x, off.to(dev), (32, 32), MEAN, STD)
    assert crop_normalize.launches == n + 1
    ref = crop_normalize_plain(x, off, (32, 32), MEAN, STD)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    bad = off.clone()
    bad[2] = torch.tensor([59, 0])
    out = crop_normalize(x, bad.to(dev), (32, 32), MEAN, STD)
    torch.cuda.synchronize()
    assert torch.isnan(out[2]).all() and torch.equal(out[[0, 1, 3]],
                                                      ref[[0, 1, 3]])
    with pytest.raises(ValueError, match="int32"):
        crop_normalize(x, off.to(dev, torch.int64), (32, 32), MEAN, STD)


def _stage_case(stage, dev):
    """A stage's step at a small size (resnet18, 64^2 crops of 80^2 tiles,
    batch 2, bf16) with its state and a batch stream."""
    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.train.loop import build_model, build_state, default_hparams
    from uemda_tpu_torch.train.steps import (
        make_align_simple_step,
        make_align_step,
        make_src_step,
        make_ssl_step,
    )

    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                              crop=(64, 64))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    cases = {
        "src": (make_src_step, dict(align_domain=True, balance_source=True)),
        "align": (make_align_step, dict(align_domain=True)),
        "ssl": (make_ssl_step, dict(balance_target=True)),
        # the zoo: OHEM with accumulation, PROCA's stage 2, each target loss
        "src-accum": (make_src_step, dict(align_domain=True,
                                          source_loss="ohem")),
        "proca": (lambda m, hp: make_align_simple_step(m, hp, 0.3),
                  dict(refine=False)),
    }
    for lt in ("ups", "ohem", "focal", "ghm", "gdp"):
        cases[f"ssl-{lt}"] = (make_ssl_step, dict(balance_target=True,
                                                  target_loss=lt))
    make, hp = cases[stage]
    state = build_state(model, cfg, 10, prototypes=torch.randn(
        6, 512, generator=torch.Generator().manual_seed(1)),
        accum_steps=2 if stage == "src-accum" else 1)
    step = make(model, default_hparams(cfg, **hp))

    def batches(seed):
        r = np.random.default_rng(seed)
        sup, _ = _grid_sup(2, 80, 80, 16, seed=seed)
        while True:
            bs = {"image": r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8),
                  "label": r.integers(-1, 6, (2, 80, 80)).astype(np.int32)}
            bt = {"image": r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8),
                  "sup": sup.astype(np.int32)}
            if stage.startswith("ssl"):
                bt["prob"] = _mine_inputs((2, 6, 80, 80), int(r.integers(99)),
                                          "cpu").permute(0, 2, 3, 1) \
                    .contiguous().half().numpy()
            yield ({k: torch.from_numpy(v).to(dev) for k, v in bs.items()},
                   {k: torch.from_numpy(v).to(dev) for k, v in bt.items()})

    return model, state, step, batches


@pytest.mark.parametrize("stage", ["src", "align", "ssl"])
def test_captured_step_equals_the_eager_step(dev, stage):
    """From one start state and one batch stream, four steps of each stage
    eager and through ``ChunkRunner`` (step 1 eager on the capture stream,
    then three replays of the captured step, with the same (seed, step)
    draws): the losses of every step within 1e-4 relative, the parameters,
    prototypes and momentum within 1e-4 of their largest value; the
    captured step holds the stage's kernel launches."""
    import copy

    from uemda_tpu_torch.train.graph import ChunkRunner

    model, state, step, batches = _stage_case(stage, dev)
    model2 = copy.deepcopy(model)
    runs = []
    for m in (model, model2):
        st = dataclasses.replace(
            state, model=m, opt=type(state.opt)(
                list(m.named_parameters()), state.opt.schedule),
            aligner=copy.deepcopy(state.aligner),
            balance_s=copy.deepcopy(state.balance_s),
            balance_t=copy.deepcopy(state.balance_t))
        step.model = m
        it = batches(5)
        pairs = [next(it) for _ in range(4)]
        if m is model:
            out = [step(st, bs, bt, 0) for bs, bt in pairs]
            stats = None
        else:
            runner = ChunkRunner(step, 0, dev)
            out = runner(st, pairs)
            assert runner.graph.replays == 3
            stats = runner.close()
        torch.cuda.synchronize()
        runs.append(([{k: float(v) for k, v in o.items()} for o in out],
                     [p.detach().clone() for p in m.parameters()],
                     st.aligner.prototypes.clone(),
                     [t.clone() for t in st.opt.trace], st.step, stats))
    (l1, p1, q1, t1, s1, _), (l2, p2, q2, t2, s2, stats) = runs
    assert s1 == s2 == 4
    for a, b in zip(l1, l2):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * max(abs(a[k]), 1e-6), (k, a, b)
    for xs, ys in ((p1, p2), (t1, t2), ([q1], [q2])):
        top = max(float(x.abs().max()) for x in xs)
        assert max(float((x - y).abs().max()) for x, y in zip(xs, ys)) \
            <= 1e-4 * top
    assert stats["replays"] == 3 and stats["launches"]["crop_normalize"] == 2
    assert stats["launches"]["instance_norm_backward"] >= 1
    assert stats["launches"]["bnact"] == 0   # train-mode BatchNorm


@pytest.mark.parametrize("stage", ["src-accum", "proca", "ssl-ups",
                                   "ssl-ohem", "ssl-focal", "ssl-ghm",
                                   "ssl-gdp"])
def test_captured_zoo_step_equals_the_eager_step(dev, stage):
    """As ``test_captured_step_equals_the_eager_step``, for the steps of the
    zoo: stage 1 with OHEM and ``accum_steps`` 2 (four micro-steps, two
    updates: the masters, momentum and running mean, the counts),
    PROCA's stage 2, and stage 3 with each target loss (for GHM and GDP
    also the histogram both heads advance). Four steps eager and through
    ``ChunkRunner``: losses within 1e-4 relative, tensors within 1e-4 of
    their largest value."""
    import copy

    from uemda_tpu_torch.train.graph import ChunkRunner

    model, state, step, batches = _stage_case(stage, dev)
    model2 = copy.deepcopy(model)
    runs = []
    for m in (model, model2):
        st = dataclasses.replace(
            state, model=m, opt=type(state.opt)(
                list(m.named_parameters()), state.opt.schedule,
                accum_steps=state.opt.accum_steps),
            aligner=copy.deepcopy(state.aligner),
            balance_s=copy.deepcopy(state.balance_s),
            balance_t=copy.deepcopy(state.balance_t),
            ghm=copy.deepcopy(state.ghm))
        step.model = m
        it = batches(7)
        pairs = [next(it) for _ in range(4)]
        if m is model:
            out = [step(st, bs, bt, 0) for bs, bt in pairs]
        else:
            runner = ChunkRunner(step, 0, dev)
            out = runner(st, pairs)
            assert runner.graph.replays == 3
            runner.close()
        torch.cuda.synchronize()
        runs.append(([{k: float(v) for k, v in o.items()} for o in out],
                     [p.detach().clone() for p in m.parameters()],
                     [t.clone() for t in st.opt.trace + st.opt.acc],
                     [st.aligner.prototypes.clone(), st.ghm.acc_sum.clone()],
                     (st.step, st.opt.count, st.opt.mini_step)))
    (l1, p1, t1, q1, c1), (l2, p2, t2, q2, c2) = runs
    assert c1 == c2 == ((4, 2, 0) if stage == "src-accum" else (4, 4, 0))
    for a, b in zip(l1, l2):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * max(abs(a[k]), 1e-6), (k, a, b)
    for xs, ys in ((p1, p2), (t1, t2), (q1[:1], q2[:1]), (q1[1:], q2[1:])):
        top = max(max(float(x.abs().max()) for x in xs), 1e-30)
        assert max(float((x - y).abs().max()) for x, y in zip(xs, ys)) \
            <= 1e-4 * top
    if stage in ("ssl-ghm", "ssl-gdp"):
        assert float(q1[1].sum()) > 0


def test_with_cp_on_the_card_equals_no_checkpointing(dev):
    """Two bf16 stage-1 steps (CORAL) with ``with_cp`` on all four stages
    against the same steps without it, from one start state on one batch
    stream: the losses within 1e-4 relative, the BatchNorm buffers equal
    after step 1 (the recompute leaves them alone) and the masters within
    1e-4 of their largest value after step 2."""
    import copy

    model, state, step, batches = _stage_case("src", dev)
    model2 = copy.deepcopy(model)
    model2.encoder.resnet.with_cp = (True,) * 4
    runs = []
    for m in (model, model2):
        st = dataclasses.replace(
            state, model=m, opt=type(state.opt)(list(m.named_parameters()),
                                                state.opt.schedule),
            balance_s=copy.deepcopy(state.balance_s))
        step.model = m
        it = batches(9)
        out = [step(st, *next(it), 0)]
        bufs = [b.clone() for b in m.buffers()]
        out.append(step(st, *next(it), 0))
        torch.cuda.synchronize()
        runs.append(([{k: float(v) for k, v in o.items()} for o in out], bufs,
                     [p.detach().clone() for p in m.parameters()]))
    (l1, b1, p1), (l2, b2, p2) = runs
    for a, b in zip(l1, l2):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * max(abs(a[k]), 1e-6), (k, a, b)
    assert all(torch.equal(x, y) for x, y in zip(b1, b2))
    top = max(float(x.abs().max()) for x in p1)
    assert max(float((x - y).abs().max()) for x, y in zip(p1, p2)) \
        <= 1e-4 * top


def test_snapshot_of_a_replaying_step_equals_a_synchronous_copy(
        dev, tmp_path):
    """``AsyncSaver`` while a captured stage-2 step replays: the state
    after step 3 copied with ``.cpu()``, then a spinner holding the
    stream, the snapshot enqueued behind it and three more replays
    enqueued behind the snapshot, which write the state in place. The file
    equals the synchronous copy exactly: the snapshot's copies sit on the
    steps' stream, before the next step's kernels."""
    from uemda_tpu_torch.train.checkpoints import AsyncSaver, load_checkpoint
    from uemda_tpu_torch.train.graph import ChunkRunner

    _, state, step, batches = _stage_case("align", dev)
    it = batches(3)
    runner = ChunkRunner(step, 0, dev)
    runner(state, [next(it) for _ in range(3)])
    ref = {k: v.cpu() for k, v in state.model.state_dict().items()}
    ref_trace = [t.cpu() for t in state.opt.trace]
    ref_proto = state.aligner.prototypes.cpu()
    saver = AsyncSaver()
    torch.cuda._sleep(500_000_000)  # ~0.25 s on the stream
    saver.save(str(tmp_path / "s.pth"), state.state_dict())
    runner(state, [next(it) for _ in range(3)])
    saver.wait()
    saver.close()
    got = load_checkpoint(str(tmp_path / "s.pth"))
    assert got["step"] == got["opt"]["count"] == 3 and state.step == 6
    assert all(torch.equal(got["model"][k], v) for k, v in ref.items())
    assert all(torch.equal(a, b) for a, b in zip(got["opt"]["trace"],
                                                 ref_trace))
    assert torch.equal(got["aligner"]["prototypes"], ref_proto)
    assert not torch.equal(state.aligner.prototypes.cpu(), ref_proto)
    runner.close()


def test_resume_into_a_captured_state_replays_from_the_loaded_values(dev):
    """A stage-2 step captured on a state, replayed to step 4; the state
    of step 2 loaded back into the same tensors (``load_state_dict``); the
    same batches again: the replays go on from the loaded values and give
    steps 3-4's losses and parameters again, bit for bit."""
    from uemda_tpu_torch.train.graph import ChunkRunner

    _, state, step, batches = _stage_case("align", dev)
    it = batches(4)
    pairs = [next(it) for _ in range(4)]
    runner = ChunkRunner(step, 0, dev)
    runner(state, pairs[:2])
    saved = _cpu_tree(state.state_dict())  # copies, on the host
    first = runner(state, pairs[2:])
    params = [p.detach().clone() for p in state.opt.params]
    state.load_state_dict(saved)
    assert state.step == state.opt.count == 2
    again = runner(state, pairs[2:])
    assert runner.graph.replays == 5
    for a, b in zip(first, again):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(p, q) for p, q in zip(params, state.opt.params))
    runner.close()


def _cpu_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_tree(v) for v in tree]
    return tree


def test_pinned_ring_never_hands_out_a_slot_in_flight(dev):
    """The upload stage's staging ring: a slot whose copy is still in
    flight (held back on its stream by a spinning kernel) is handed out
    again only after that copy completes; and batches uploaded through
    ``upload_batches`` while the consumer's stream is kept busy arrive
    intact and in order."""
    from uemda_tpu_torch.datasets.prefetch import PinnedRing, upload_batches
    from uemda_tpu_torch.utils import trace

    ring = PinnedRing(2)
    stream = torch.cuda.Stream()
    first = None
    trace.enable()
    try:
        waits = trace.snapshot()["counters"].get("upload.ring_waits", 0)
        with torch.cuda.stream(stream):
            for i in range(2):
                host, ev = ring.acquire("x", (1 << 20,), np.float32)
                host.fill_(i)
                if i == 0:
                    torch.cuda._sleep(200_000_000)  # ~0.1 s on the stream
                    first = host
                torch.empty_like(host, device=dev).copy_(host,
                                                         non_blocking=True)
                ev.record(stream)
            host, ev = ring.acquire("x", (1 << 20,), np.float32)
        waits = trace.snapshot()["counters"]["upload.ring_waits"] - waits
    finally:
        trace.disable()
    assert host is first and ev.query() and waits == 1

    src = [{"x": np.full((64, 64), i, np.float32),
            "y": np.full((8,), -i, np.int32)} for i in range(12)]
    got = []
    for b in upload_batches(iter(src), dev):
        torch.cuda._sleep(20_000_000)  # the step the batch would feed
        got.append({k: v.clone() for k, v in b.items()})
    torch.cuda.synchronize()
    assert len(got) == 12
    for i, b in enumerate(got):
        assert bool((b["x"] == i).all()) and bool((b["y"] == -i).all())


def _serving_modes(model):
    """The bf16 serving modes the captured-predictor tests hold to eager
    calls: the fast path, all four stages in K4, and the int8 fast path
    with dynamic scales."""
    from uemda_tpu_torch.infer.fastpath import build_fastpath

    return {"fast path": build_fastpath(model, dtype=torch.bfloat16),
            "fused (1, 2, 3, 4)": build_fastpath(
                model, dtype=torch.bfloat16, fused_stages=(1, 2, 3, 4)),
            "int8 dynamic": build_fastpath(model, dtype=torch.bfloat16,
                                           int8=True)}


@pytest.mark.parametrize("mode", ["fast path", "fused (1, 2, 3, 4)",
                                  "int8 dynamic"])
def test_captured_predictor_equals_eager_calls(dev, mode):
    """ResNet-50 OS16 in bf16, a 96x96 image in 64^2 windows with 8-view
    TTA at batch 2 (4 windows x 8 views x 2 = 64 tiles a forward): the
    captured predictor's f32 probabilities equal eager calls' within 2e-4
    (the same kernels on the same inputs): the first call (the warm-up on
    the capture stream, then the capture) and two replays, the second with
    another input than the first (the static input is re-read); the replay
    holds K1, K2 and K3 (and 12 K4 launches when fused), and the first
    call's capture is the only one. The wrappers' counts are the device's
    launches: over the three calls, three times a replay's launches (the
    warm-up's and two replays'; the capture adds none)."""
    from uemda_tpu_torch.infer.graph import kernel_wrappers
    from uemda_tpu_torch.infer.slide import make_predictor

    model = DeeplabV2(DeeplabV2Config.uemda_default(6),
                      generator=torch.Generator().manual_seed(0))
    fm = _serving_modes(model)[mode]
    kw = dict(tile=(64, 64), image_hw=(96, 96), tta=True,
              compute_dtype=torch.bfloat16)
    eager = make_predictor(fm, capture=False, **kw)
    graph = make_predictor(fm, **kw)
    wrappers = kernel_wrappers()
    counted = collections.Counter()
    outs = []
    for seed in (1, 2, 1):
        x = _randn((2, 3, 96, 96), seed, dev, torch.float32) \
            .contiguous(memory_format=CL)
        ref = eager(x)
        before = {w.__name__: w.launches for w in wrappers}
        got = graph(x)
        counted.update({w.__name__: w.launches - before[w.__name__]
                        for w in wrappers})
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (2, 6, 96, 96)
        assert float((got - ref).abs().max()) <= 2e-4, seed
        outs.append(got.clone())
    assert float((outs[1] - outs[2]).abs().max()) > 1e-3
    st = graph.close()
    assert st["replays"] == 2 and eager.stats() is None
    for name in ("instance_norm", "stem_pool", "tail_upsample_softmax_mean"):
        assert st["launches"][name] >= 1, st
    assert st["launches"]["bottleneck_identity"] == (
        12 if mode.startswith("fused") else 0)
    assert all(counted[name] == 3 * n for name, n in st["launches"].items()), (
        counted, st)


def test_predictor_close_returns_the_pool(dev):
    """The graph's private pool is released by ``close()``: the device
    memory reserved falls by at least 90% of the pool the capture
    reserved."""
    from uemda_tpu_torch.infer.fastpath import build_fastpath
    from uemda_tpu_torch.infer.slide import make_predictor

    model = DeeplabV2(DeeplabV2Config.uemda_default(6),
                      generator=torch.Generator().manual_seed(0))
    graph = make_predictor(build_fastpath(model, dtype=torch.bfloat16),
                           (64, 64), (64, 64), compute_dtype=torch.bfloat16)
    x = _randn((4, 3, 64, 64), 3, dev, torch.float32)
    graph(x)
    torch.cuda.synchronize()
    pool = graph.stats()["pool_bytes"]
    live = torch.cuda.memory_reserved()
    assert pool > 0
    graph.close()
    assert graph.graph is None
    assert live - torch.cuda.memory_reserved() >= 0.9 * pool


def test_evaluation_and_sweep_through_the_graph_equal_eager_calls(dev):
    """``evaluate_dataset`` and the pseudo-label sweep of three 96^2 images
    at batch 2 (a padded last batch), 64^2 windows, TTA, on a ResNet-18
    fast path in bf16: through the captured predictor the confusion matrix
    and the fp16 probabilities equal those of eager calls."""
    from uemda_tpu_torch.datasets.meta import IsprsDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.infer.evaluate import evaluate_dataset
    from uemda_tpu_torch.infer.fastpath import build_fastpath
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels

    model = DeeplabV2(DeeplabV2Config.uemda_default(6, resnet_type="resnet18"),
                      generator=torch.Generator().manual_seed(0))
    data = synthetic_split(IsprsDA, n=3, hw=96, seed=1)
    kw = dict(tile=(64, 64), tta=True, batch_size=2,
              compute_dtype=torch.bfloat16, device=dev)
    fm = build_fastpath(model, dtype=torch.bfloat16)
    runs = [evaluate_dataset(fm, data, MEAN, STD, capture=c, **kw)
            for c in (True, False)]
    assert runs[0][0]["confusion_matrix"] == runs[1][0]["confusion_matrix"]
    assert runs[0][1] == runs[1][1]
    sweeps = [generate_pseudo_labels(model, data, MEAN, STD, capture=c, **kw)
              for c in (True, False)]
    assert list(sweeps[0]) == list(sweeps[1]) == [
        data.filename(i) for i in range(3)]
    for name in sweeps[0]:
        np.testing.assert_array_equal(sweeps[0][name], sweeps[1][name])


def test_capture_failure_raises_and_never_falls_back(dev):
    """A predictor whose model reads a value back to the host cannot be
    captured: the call raises, no graph is kept, and the next call raises
    again instead of running eagerly."""
    from uemda_tpu_torch.infer.slide import make_predictor

    calls = []

    def model(x):  # a host read inside the forward
        calls.append(float(x.abs().max()))
        return torch.softmax(x[:, :1].repeat(1, 6, 1, 1).float(), dim=1)

    graph = make_predictor(model, (32, 32), (32, 32),
                           compute_dtype=torch.float32)
    x = _randn((2, 3, 32, 32), 4, dev, torch.float32)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            graph(x)
        assert graph.graph is None
    torch.cuda.synchronize()
    assert len(calls) == 2  # each call's warm-up; its capture fails at the read


def _da_case(stage, dev):
    """The adversarial (``adv``, ``adv-accum``: ``accum_steps`` 2) or DCA
    (``dca``, the source class balance on) step at ``_stage_case``'s size
    (resnet18, 64^2 crops of 80^2 tiles, batch 2, bf16) with a start-state
    factory -- each call a fresh copy of the same model, D, optimizers and
    balances -- and a batch stream."""
    import copy

    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.train.adversarial import create_adv_state, make_adv_step
    from uemda_tpu_torch.train.loop import build_model, build_state, default_hparams
    from uemda_tpu_torch.train.steps import make_dca_step

    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                              crop=(64, 64))
    model0 = build_model(cfg, generator=torch.Generator().manual_seed(0))
    accum = 2 if stage == "adv-accum" else 1

    def start():
        model = copy.deepcopy(model0)
        state = build_state(model, cfg, 10, accum_steps=accum)
        if stage.startswith("adv"):
            state = create_adv_state(state, 6)
            step = make_adv_step(model, default_hparams(cfg), lambda_adv=0.1)
        else:
            step = make_dca_step(model, default_hparams(cfg,
                                                        balance_source=True))
        return state, step

    def batches(seed):
        r = np.random.default_rng(seed)
        while True:
            bs = {"image": r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8),
                  "label": r.integers(-1, 6, (2, 80, 80)).astype(np.int32)}
            bt = {"image": r.integers(0, 256, (2, 80, 80, 3)).astype(np.uint8)}
            if stage == "dca":
                bt["prob"] = _mine_inputs((2, 6, 80, 80), int(r.integers(99)),
                                          "cpu").permute(0, 2, 3, 1) \
                    .contiguous().half().numpy()
            yield ({k: torch.from_numpy(v).to(dev) for k, v in bs.items()},
                   {k: torch.from_numpy(v).to(dev) for k, v in bt.items()})

    return start, batches


@pytest.mark.parametrize("stage", ["adv", "adv-accum", "dca"])
def test_captured_da_step_equals_the_eager_step(dev, stage):
    """The adversarial step (D's update, its Adam count on the device, and
    with ``accum_steps`` 2 the segmenter's held updates) and the DCA step,
    four steps eager and through ``ChunkRunner`` from copies of one start
    state: the losses of every step within 1e-4 relative; the segmenter's
    masters, momentum and (DCA) source class balance and D's parameters
    and Adam moments within 1e-4 of their largest value; a replay holds
    the crop and instance-norm launches, and leaves D's gradients pointed
    at the graph's."""
    from uemda_tpu_torch.train.graph import ChunkRunner

    start, batches = _da_case(stage, dev)
    runs = []
    for captured in (False, True):
        st, step = start()
        it = batches(11)
        pairs = [next(it) for _ in range(4)]
        stats = None
        if captured:
            runner = ChunkRunner(step, 0, dev)
            out = runner(st, pairs)
            assert runner.graph.replays == 3
            grads = runner.graph.grads
            assert all(p.grad is g for p, g in zip(st.grad_params(), grads))
            stats = runner.close()
        else:
            out = [step(st, bs, bt, 0) for bs, bt in pairs]
        torch.cuda.synchronize()
        tensors = {"masters": [p.detach().clone()
                               for p in st.model.parameters()],
                   "momentum": [t.clone() for t in st.opt.trace]}
        if stage.startswith("adv"):
            tensors.update(d=[p.detach().clone()
                              for p in st.disc.parameters()],
                           mu=[t.clone() for t in st.d_opt.mu],
                           nu=[t.clone() for t in st.d_opt.nu])
            assert float(st.d_opt.count) == 4
        else:
            tensors["balance"] = [st.balance_s.freq.clone()]
        assert st.step == 4 and st.opt.count == (2 if stage == "adv-accum"
                                                 else 4)
        runs.append(([{k: float(v) for k, v in o.items()} for o in out],
                     tensors, stats))
    (l1, t1, _), (l2, t2, stats) = runs
    for a, b in zip(l1, l2):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * max(abs(a[k]), 1e-6), (k, a, b)
    for name in t1:
        top = max(float(x.abs().max()) for x in t1[name])
        err = max(float((x - y).abs().max()) for x, y in zip(t1[name],
                                                            t2[name]))
        assert err <= 1e-4 * top, (name, err, top)
    assert stats["launches"]["crop_normalize"] == 2
    assert stats["launches"]["instance_norm_backward"] >= 1


def test_trans_norm_and_discriminator_in_bf16_against_f32(dev):
    """``TransNorm2d`` (a train step on [source; target] with its four
    running statistics, then eval) and ``FCDiscriminator`` on bf16 inputs
    and weights against the same in f32: within bf16's 1.6e-2 of the f32
    result's largest value; TransNorm's statistics are f32 either way."""
    from uemda_tpu_torch.models.discriminator import FCDiscriminator
    from uemda_tpu_torch.models.trans_norm import TransNorm2d

    x = _randn((4, 32, 16, 16), 3, dev, torch.float32, shift=0.5)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        tn = TransNorm2d(32, device=dev,
                         generator=torch.Generator().manual_seed(0)).train()
        y = tn(x.to(dt))
        assert y.dtype == dt and tn.mean_source.dtype == torch.float32
        stats = [getattr(tn, k).clone() for k in
                 ("mean_source", "mean_target", "var_source", "var_target")]
        tn.eval()
        z = tn(x.to(dt))
        outs[dt] = (y.float(), z.float(), stats)
    (y32, z32, s32), (y16, z16, s16) = outs[torch.float32], outs[torch.bfloat16]
    for a, b in [(y16, y32), (z16, z32)] + list(zip(s16, s32)):
        assert float((a - b).abs().max()) <= 1.6e-2 * float(b.abs().max())
    d = FCDiscriminator(6, device=dev,
                        generator=torch.Generator().manual_seed(0))
    soft = torch.softmax(_randn((2, 6, 128, 128), 4, dev, torch.float32,
                                scale=3.0), dim=1)
    with torch.no_grad():
        ref = d(soft)
        got = d.to(torch.bfloat16)(soft.to(torch.bfloat16))
    assert got.shape == ref.shape == (2, 1, 4, 4)
    assert float((got.float() - ref).abs().max()) <= \
        1.6e-2 * float(ref.abs().max())


def _lsc_crops(b, crop, seed):
    """``b`` crops of ``crop``^2 of the shrunk LSC map (region 16, 20
    iterations) of one synthetic 1024^2 LoveDA tile, from the port's
    binding: ids numbered over the whole tile, as stage 2 crops them."""
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.superpixels import superpixels_with_shrink

    img = synthetic_split(LoveDA, n=1, hw=1024, seed=seed,
                          domain_shift=20.0).images[0]
    _, _, shrunk = superpixels_with_shrink(img, iterations=20)
    r = np.random.default_rng(seed)
    offs = r.integers(0, 1024 - crop + 1, (b, 2))
    return np.stack([shrunk[y:y + crop, x:x + crop] for y, x in offs])


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_segment_kernels_on_an_lsc_map(dev, ids_dtype):
    """K5 and K7 at the 2urban stage-2 shape, (8, 512^2, 7) f32 with S =
    max_segments_for(2urban) = 4128, on crops of an irregular LSC map from
    the port's binding (grid maps are the other tests' ids): both exactly
    equal to their plain versions, K5 on its window route."""
    sup = _lsc_crops(8, 512, seed=4)
    assert sup.max() == 4096  # the boundary id (1024/16)^2
    ids = torch.from_numpy(sup.reshape(8, -1)).to(dev, ids_dtype)
    val = torch.softmax(_randn((8, 512 * 512, 7), 9, dev, torch.float32,
                               scale=3.0), dim=-1)
    got = segment_max(val, ids, 4128)
    assert segment_max.route == "window"
    ref = segment_max_plain(val, ids, 4128)
    g = segment_gather(got, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(g, segment_gather_plain(ref, ids))
    assert not torch.isnan(g).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_with_aux_probs_equal_the_default_forward(dev, dtype):
    """The flagship model (ResNet-50 OS16, twin PPM heads, instance norm, 7
    classes) in eval mode on the card, batch 2 at 256^2: ``with_aux``'s
    probabilities bit-equal to the default forward's, through one more K3
    and K1 launch each; the stride-16 logits and the 2048-channel
    feature beside them."""
    model = DeeplabV2(DeeplabV2Config.uemda_default(7), device=dev,
                      generator=torch.Generator().manual_seed(0)).to(dtype)
    x = _randn((2, 3, 256, 256), 1, dev, dtype).contiguous(memory_format=CL)
    n3, n1 = tail_upsample_softmax_mean.launches, instance_norm.launches
    with torch.no_grad():
        plain = model(x)
        probs, x1, x2, feat = model(x, with_aux=True)
    torch.cuda.synchronize()
    assert torch.equal(probs, plain)
    assert (x1.shape, x2.shape, feat.shape) == (
        (2, 7, 16, 16), (2, 7, 16, 16), (2, 2048, 16, 16))
    assert not torch.equal(x1, x2)
    assert (tail_upsample_softmax_mean.launches - n3,
            instance_norm.launches - n1) == (2, 2)


@pytest.fixture
def nccl_group(dev):
    """A process group of this one process on NCCL, destroyed after."""
    import socket

    import torch.distributed as dist

    from uemda_tpu_torch.parallel.multihost import init_multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda")
    yield dist.get_backend()
    dist.destroy_process_group()


@pytest.mark.parametrize("stage", ["src", "align", "ssl"])
def test_world_size_1_nccl_step_equals_the_plain_step(dev, stage):
    """Each stage's step in an NCCL group of one process (the data-parallel
    code at world size 1: every collective helper the identity) against
    the same steps without a group, from one start and one batch stream:
    two eager steps, then two more through ``ChunkRunner``'s captured
    graph in the group, against two more plain eager steps; every loss
    equal to 1e-4 relative (bit-equal expected)."""
    import copy
    import socket

    import torch.distributed as dist

    from uemda_tpu_torch.parallel.multihost import init_multihost
    from uemda_tpu_torch.train.graph import ChunkRunner

    model, state, step, batches = _stage_case(stage, dev)
    model2 = copy.deepcopy(model)
    runs = []
    for m in (model, model2):
        st = dataclasses.replace(
            state, model=m, opt=type(state.opt)(
                list(m.named_parameters()), state.opt.schedule),
            aligner=copy.deepcopy(state.aligner),
            balance_s=copy.deepcopy(state.balance_s),
            balance_t=copy.deepcopy(state.balance_t))
        step.model = m
        it = batches(7)
        pairs = [next(it) for _ in range(4)]
        grouped = m is model2
        if grouped:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            init_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda")
        try:
            out = [step(st, bs, bt, 0) for bs, bt in pairs[:2]]
            if grouped:
                assert dist.get_backend() == "nccl"
                runner = ChunkRunner(step, 0, dev)
                out += runner(st, pairs[2:])
                runner.close()
            else:
                out += [step(st, bs, bt, 0) for bs, bt in pairs[2:]]
            torch.cuda.synchronize()
        finally:
            if grouped:
                dist.destroy_process_group()
        runs.append([{k: float(v) for k, v in o.items()} for o in out])
    for a, b in zip(*runs):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * max(abs(a[k]), 1e-6), (k, a, b)


@pytest.mark.parametrize("fast", [False, True])
def test_raster_predictor_equals_the_padded_slide_predictor(dev, nccl_group,
                                                             fast):
    """The raster predictor at world size 1 on NCCL (resnet50, bf16, 8-view
    TTA, 64^2 tiles, a 200 x 150 raster; the fast path with K2, K3 and K4
    on stages (1, 2)) with every window in one forward, against
    ``make_predictor`` over the padded raster: bit-equal, the same batch
    through the same kernels."""
    from uemda_tpu_torch.infer.fastpath import build_fastpath
    from uemda_tpu_torch.infer.raster import RasterPlan, make_raster_predictor
    from uemda_tpu_torch.infer.slide import make_predictor
    from uemda_tpu_torch.ops.resblock import bottleneck_identity

    model = DeeplabV2(DeeplabV2Config.uemda_default(6, resnet_type="resnet50"),
                      device=dev, generator=torch.Generator().manual_seed(4))
    model.eval()
    net = (build_fastpath(model, fused_stages=(1, 2)) if fast
           else model.to(torch.bfloat16))
    hw, tile = (200, 150), (64, 64)
    x = torch.randn((3,) + hw, generator=torch.Generator().manual_seed(5)
                    ).to(dev)
    plan = RasterPlan(hw, tile, 0.5, 1)
    n_win = len(plan.origins(True))
    k4 = bottleneck_identity.launches
    got = make_raster_predictor(net, hw, tile, tta=True, window_chunk=n_win,
                                compute_dtype=torch.bfloat16,
                                return_probs=True)(x)
    assert not fast or bottleneck_identity.launches > k4
    padded = torch.zeros((1, 3, plan.hp, plan.wp), device=dev)
    padded[0, :, :hw[0], :hw[1]] = x
    with make_predictor(net, tile, (plan.hp, plan.wp), tta=True,
                        compute_dtype=torch.bfloat16) as single:
        want = single(padded)[0, :, :hw[0], :hw[1]]
    assert torch.equal(got, want), float((got - want).abs().max())


def _collective_bodies(x, dy, w, b, v):
    """What ``parallel/mesh.py``'s helpers run at world size > 1 (at 1 they
    return early): the global BatchNorm forward and backward, the autograd
    all-reduce sum, the flat gradient all-reduce and the all-gather."""
    from uemda_tpu_torch.parallel import mesh

    xi = x.detach().clone().requires_grad_()
    wi = w.detach().clone().requires_grad_()
    bi = b.detach().clone().requires_grad_()
    y, mean, var = mesh._GlobalBatchNorm.apply(xi, wi, bi, 1e-5)
    (mesh._AllReduceSum.apply(y) * dy).sum().backward()
    mesh._all_reduce_flat([wi.grad, bi.grad])
    return [y.detach(), mean, var, xi.grad, wi.grad, bi.grad,
            mesh._all_gather(v)]


def test_collective_bodies_replay_in_a_cuda_graph_on_nccl(dev, nccl_group):
    """The collectives a data-parallel step takes at world size > 1, in the
    NCCL group of one process: eagerly against the library BatchNorm
    (y, dx 1e-4; dw, db 1e-3), then captured in one CUDA graph (what
    ``--steps-per-call`` captures with each step) and replayed on new
    inputs: equal to the eager bodies on those inputs within 1e-5."""
    import torch.nn.functional as F

    assert nccl_group == "nccl"
    g = torch.Generator(device=dev).manual_seed(1)

    def inputs():
        return [torch.randn(8, 64, 32, 32, generator=g, device=dev) * 2 + 1,
                torch.randn(8, 64, 32, 32, generator=g, device=dev),
                torch.rand(64, generator=g, device=dev) + 0.5,
                torch.randn(64, generator=g, device=dev),
                torch.randn(4, 6, generator=g, device=dev)]

    static = inputs()
    eager = _collective_bodies(*static)
    x, dy, w, b, v = (t.clone().requires_grad_(i in (0, 2, 3))
                      for i, t in enumerate(static))
    y = F.batch_norm(x, None, None, w, b, True, 0.0, 1e-5)
    (y * dy).sum().backward()
    lib = [y.detach(), x.detach().mean((0, 2, 3)),
           x.detach().var((0, 2, 3), unbiased=False), x.grad,
           w.grad, b.grad, v]
    for got, want, tol in zip(eager, lib,
                              (1e-4, 1e-5, 1e-4, 1e-4, 1e-3, 1e-3, 0.0)):
        assert float((got - want).abs().max()) <= tol
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            _collective_bodies(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = _collective_bodies(*static)
    fresh = inputs()
    for t, f in zip(static, fresh):
        t.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(out, _collective_bodies(*fresh)):
        assert float((got - want).abs().max()) <= 1e-5


def _dp_steps_on(dev, name, graph):
    """Two f32 steps of the step case ``name`` of
    ``tests/torch_parallel_cases.py`` (resnet18 without instance norm,
    global batch 4) on ``dev``, on this rank's rows: through
    ``ChunkRunner`` (``graph``: the first eager on the capture stream, the
    second a replay of the captured step) or eager. Returns the steps'
    losses, the parameters' sketches before and after, and the model's
    buffers (BatchNorm's running statistics)."""
    import torch_parallel_cases as cases  # pytest puts tests/ on sys.path
    from uemda_tpu_torch.train import steps as S
    from uemda_tpu_torch.train.graph import ChunkRunner
    from uemda_tpu_torch.train.loop import build_state

    kind, hp, _ = cases.STEP_CASES[name]
    model = cases._model(1).to(dev)
    proto = np.random.default_rng(3).normal(
        size=(cases.C, cases.K)).astype(np.float32)
    state = build_state(model, cases._cfg(), 40, prototypes=proto,
                        feat_channels=cases.K)
    make = {"src": S.make_src_step, "align": S.make_align_step,
            "ssl": S.make_ssl_step}[kind]
    step = make(model, S.StageHParams(**hp))

    def sketch():
        return cases.sketch((n, p.detach().cpu())
                            for n, p in model.named_parameters())

    pairs = []
    for i in range(2):
        bs, bt = cases.global_batches(10 + i)
        if kind in ("src", "align"):
            bt = {k: v for k, v in bt.items()
                  if k == "image" or (k == "sup" and kind == "align")}
        pairs.append(tuple({k: v.to(dev) for k, v in cases.local(b).items()}
                           for b in (bs, bt)))
    start = sketch()
    if graph:
        runner = ChunkRunner(step, 2333, dev)
        out = runner(state, pairs)
        runner.close()
    else:
        out = [step(state, bs, bt, 2333) for bs, bt in pairs]
    torch.cuda.synchronize()
    params = {n for n, _ in model.named_parameters()}
    return {"loss": [{k: float(v) for k, v in o.items()} for o in out],
            "start": start, "end": sketch(),
            "buffers": {k: v.cpu() for k, v in model.state_dict().items()
                        if k not in params and v.is_floating_point()}}


def _raster_case(dev):
    """(the raster predictor's f32 probabilities at this group's world
    size, ``make_predictor``'s over the padded raster): resnet50, 8-view
    TTA, 64^2 tiles, a 200 x 150 raster."""
    from uemda_tpu_torch.infer.raster import RasterPlan, make_raster_predictor
    from uemda_tpu_torch.infer.slide import make_predictor
    from uemda_tpu_torch.parallel import mesh

    model = DeeplabV2(DeeplabV2Config.uemda_default(6, resnet_type="resnet50"),
                      device=dev, generator=torch.Generator().manual_seed(4))
    model.eval()
    hw, tile = (200, 150), (64, 64)
    x = torch.randn((3,) + hw, generator=torch.Generator().manual_seed(5)
                    ).to(dev)
    got = make_raster_predictor(model, hw, tile, tta=True,
                                compute_dtype=torch.float32,
                                return_probs=True)(x).clone()
    plan = RasterPlan(hw, tile, 0.5, mesh.world_size())
    padded = torch.zeros((1, 3, plan.hp, plan.wp), device=dev)
    padded[0, :, :hw[0], :hw[1]] = x
    with make_predictor(model, tile, (plan.hp, plan.wp), tta=True,
                        compute_dtype=torch.float32) as single:
        want = single(padded)[0, :, :hw[0], :hw[1]].clone()
    return got, want


DP_CARD_CASES = ("src", "align", "ssl")


def _two_card_rank(rank, port, path):
    """Rank ``rank`` of ``test_two_cards_equal_one_card_at_the_global_batch``
    on ``cuda:<rank>`` in an NCCL group of two: the step cases and the
    raster, saved to ``<path>_<rank>.pt``."""
    import torch.distributed as dist

    from uemda_tpu_torch.parallel.multihost import init_multihost

    torch.backends.cudnn.allow_tf32 = False   # as the 1-card reference
    dev = init_multihost(f"127.0.0.1:{port}", 2, rank, device="cuda",
                         local_rank=rank)
    try:
        res = {n: _dp_steps_on(dev, n, graph=True) for n in DP_CARD_CASES}
        got, want = _raster_case(dev)
        res["raster"] = (got.cpu(), float((got - want).abs().max()))
    finally:
        dist.destroy_process_group()
    torch.save(res, f"{path}_{rank}.pt")


def test_two_cards_equal_one_card_at_the_global_batch(dev, tmp_path):
    """Two NCCL ranks on two cards (skipped with fewer): stages 1-3 at
    global batch 4, f32 without TF32 (cuDNN's default TF32 convolutions
    differ by ~1e-4 between a batch of 2 and one of 4), two steps through
    ``ChunkRunner`` (the second a replay of the captured step with its
    collectives), against two eager steps of one card at the global batch,
    with the CPU tests' bounds: every loss within 1e-4 relative, the
    parameters' fingerprint within 1e-4 and their update within 1% of the
    1-card update's norm, the BatchNorm buffers within 1e-4 of their
    largest entry. The raster predictor at 2 ranks (halo rows and tails
    over NCCL point-to-point) within 1e-5 of the single predictor over the
    padded raster and of the 1-card raster: each rank's band forwards
    another batch of windows. Prints each largest difference."""
    import socket

    import torch.multiprocessing as mp

    if torch.cuda.device_count() < 2:
        pytest.skip("two cards needed")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = {n: _dp_steps_on(dev, n, graph=False) for n in DP_CARD_CASES}
        one_raster, _ = _raster_case(dev)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = str(tmp_path / "rank")
    mp.spawn(_two_card_rank, args=(port, path), nprocs=2, join=True)

    def sq(a, b):   # ||a - b||^2 estimated from the sketches' samples
        return sum(float(((v.double() - b["sample"][k][0].double()) ** 2)
                         .sum()) * n / v.numel()
                   for k, (v, n) in a["sample"].items())

    worst = collections.defaultdict(float)   # (what) -> largest measure
    for r in range(2):
        res = torch.load(f"{path}_{r}.pt")
        for name in DP_CARD_CASES:
            got, want = res[name], ref[name]
            for i, (a, b) in enumerate(zip(got["loss"], want["loss"])):
                for k in b:
                    rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                    worst[f"{name} step {i + 1} loss"] = max(
                        worst[f"{name} step {i + 1} loss"], rel)
            fp = want["end"]["fp"]
            worst[f"{name} fingerprint"] = max(
                worst[f"{name} fingerprint"],
                abs(got["end"]["fp"] - fp) / fp)
            worst[f"{name} update"] = max(
                worst[f"{name} update"],
                (sq(got["end"], want["end"])
                 / sq(want["end"], want["start"])) ** 0.5)
            for k, w in want["buffers"].items():
                worst[f"{name} buffers"] = max(
                    worst[f"{name} buffers"],
                    float((got["buffers"][k] - w).abs().max())
                    / (float(w.abs().max()) + 1e-12))
        got, err = res["raster"]
        worst["raster vs padded"] = max(worst["raster vs padded"], err)
        worst["raster vs 1 card"] = max(
            worst["raster vs 1 card"],
            float((got - one_raster.cpu()).abs().max()))
    print("two cards against one:", dict(worst))
    limits = {"loss": 1e-4, "fingerprint": 1e-4, "update": 1e-2,
              "buffers": 1e-4, "padded": 1e-5, "card": 1e-5}
    bad = {k: v for k, v in worst.items()
           if not v <= limits[k.split()[-1]]}
    assert not bad, bad


def test_sample_features_on_the_card_equals_the_cpu(dev):
    """``tsne_dataset.sample_features`` (the train-mode forward, K1 on the
    card) against the same model on the CPU (plain instance norm):
    ResNet-18, two 128^2 LoveDA tiles, f32 without TF32; the same picks,
    the features within the eval forward's gate (rtol 1e-3 / atol 2e-4),
    K1 launched, every BatchNorm buffer unchanged on both sides."""
    import copy

    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.tools.tsne_dataset import sample_features

    ds = synthetic_split(LoveDA, n=2, hw=128, seed=3)
    cpu = DeeplabV2(DeeplabV2Config.uemda_default(7, resnet_type="resnet18"),
                    device="cpu", generator=torch.Generator().manual_seed(6))
    card = copy.deepcopy(cpu).to(dev)
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    mean, std = (120.0, 82.0, 81.0), (55.0, 39.0, 38.0)
    k1 = instance_norm.launches
    got, got_l = sample_features(card, ds, mean, std, samples_per_image=32)
    assert instance_norm.launches > k1
    want, want_l = sample_features(cpu, ds, mean, std, samples_per_image=32)
    assert np.array_equal(got_l, want_l) and got.shape == (64, 512)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    for model in (cpu, card):
        for k, v in model.state_dict().items():
            assert torch.equal(v.cpu(), before[k]), k


def test_slide_predict_equals_the_eager_predictor(dev):
    """``slide_predict`` (one call, no capture) bit-equal to an eager
    ``make_predictor`` on the same bf16 model, with and without TTA:
    ResNet-18, a (2, 3, 160, 96) batch, 64^2 tiles; K3 launched."""
    from uemda_tpu_torch.infer.slide import make_predictor, slide_predict

    model = DeeplabV2(DeeplabV2Config.uemda_default(6, resnet_type="resnet18"),
                      device=dev, generator=torch.Generator().manual_seed(2))
    model = model.to(torch.bfloat16)
    x = _randn((2, 3, 160, 96), 8, dev, torch.float32)
    for tta in (False, True):
        k3 = tail_upsample_softmax_mean.launches
        got = slide_predict(model, x, (64, 64), tta=tta)
        assert tail_upsample_softmax_mean.launches > k3
        with make_predictor(model, (64, 64), (160, 96), tta=tta,
                            capture=False) as eager:
            want = eager(x)
        assert got.shape == (2, 6, 160, 96) and torch.equal(got, want), tta


def test_profile_summary_reads_a_cuda_trace(dev, tmp_path):
    """A chrome trace of matmuls on two streams and a copy: the reader
    finds the card's events; each stream's busy time is at most its
    events' summed durations (a Hopper kernel may start before its
    predecessor on the stream ends) and equals their union counted
    apart, to 1e-6; the device's busy time lies between the largest
    stream's and their sum; both matmuls are in the top list with their
    five calls."""
    import json as json_

    from torch.profiler import ProfilerActivity, profile

    from uemda_tpu_torch.tools import profile_summary

    a = torch.randn(2048, 2048, device=dev)
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            b = a @ a
            with torch.cuda.stream(side):
                c = a @ a.t()
        host = c.cpu()
        torch.cuda.synchronize()
    assert host.shape == b.shape
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = profile_summary.load_events(path)
    res = profile_summary.main([path, "--top", "3"])[path]
    assert res["devices"], "no device events in a CUDA trace"
    for pid, s in res["devices"].items():
        lines = s["line_busy_us"]
        for tid, busy in lines.items():
            iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("cat") in profile_summary.DEVICE_CATS
                        and e["pid"] == pid and e["tid"] == tid)
            union, end = 0, None
            for a0, a1 in iv:
                start = a0 if end is None else max(a0, end)
                union += max(a1 - start, 0)
                end = a1 if end is None else max(end, a1)
            summed = sum(a1 - a0 for a0, a1 in iv)
            assert abs(busy * 1e3 - union) <= 1e-6 * union, (tid, busy, union)
            assert union <= summed
        assert max(lines.values()) <= s["busy_us"] <= sum(lines.values()) \
            + 1e-9
        assert s["busy_us"] <= s["span_us"]
        assert sum(s["calls"][n] >= 5 for n, _ in s["top"]) >= 2, s["top"]
    assert json_.loads(open(path).read())["traceEvents"]


def _two_phases(dev, cycles):
    from uemda_tpu_torch.utils import trace

    with trace.phases(dev):
        trace.phase("one")
        torch.cuda._sleep(cycles[0])
        trace.phase("two")
        torch.cuda._sleep(cycles[1])


def test_phase_timers_of_a_captured_graph(dev):
    """A captured toy step of two phases (``torch.cuda._sleep`` of about 5
    and 10 ms): five replays run back to back with no synchronisation
    between them, then one ``snapshot`` reads each phase's device time
    within 5% of the same sleeps timed by CUDA events, and the replay's as
    their sum. The same step captured with tracing off holds no marker: a
    profiler trace of its replay has no ``uemda_phase_mark`` kernel, where
    the traced graph's replay has three."""
    from torch.profiler import ProfilerActivity, profile

    from uemda_tpu_torch.utils import trace

    cycles = (10_000_000, 20_000_000)
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ref = [[], []]
    for _ in range(3):
        evs[0].record()
        torch.cuda._sleep(cycles[0])
        evs[1].record()
        torch.cuda._sleep(cycles[1])
        evs[2].record()
        torch.cuda.synchronize()
        ref[0].append(evs[0].elapsed_time(evs[1]))
        ref[1].append(evs[1].elapsed_time(evs[2]))
    ref = [float(np.median(r)) for r in ref]

    def captured():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            _two_phases(dev, cycles)   # eager: makes the ring
        torch.cuda.current_stream().wait_stream(stream)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            _two_phases(dev, cycles)
        return g

    def marks(g):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            g.replay()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if "uemda_phase_mark" in e.key)

    trace.reset()
    trace.enable()
    try:
        g = captured()
        before = trace.snapshot()
        for _ in range(5):
            g.replay()
        after = trace.snapshot()
        assert after["replays"]["n"] - before["replays"]["n"] == 5
        assert after["replays"]["lost"] == 0
        got = [(after["phases"][p]["ns"] - before["phases"].get(
            p, {"ns": 0})["ns"]) / 5 / 1e6 for p in ("one", "two")]
        whole = (after["replays"]["ns"] - before["replays"]["ns"]) / 5 / 1e6
        assert marks(g) == 3
    finally:
        trace.disable()
        trace.reset()
    for g_ms, r_ms in zip(got, ref):
        assert abs(g_ms - r_ms) <= 0.05 * r_ms, (got, ref)
    assert abs(whole - sum(got)) <= 1e-3 * whole
    assert marks(captured()) == 0


def test_profile_dir_spans_the_sweeps_readback(dev, tmp_path):
    """On the card the sweeps' host waits land in the run's ``spans.json``
    (``run_regen_chunks`` with ``profile_dir``): ``readback.wait`` once a
    batch, and the upload worker's copies under the batch that started it;
    the evaluations' apart, under ``loop.eval``. Each sweep's first batch
    captures its predictor; the second is a replay (``predict.launch``)."""
    from test_torch_trace import profile_regen_run   # beside this file

    spans = profile_regen_run(tmp_path / "prof", dev)["spans"]
    for under in ("", "loop.eval/"):
        assert spans[under + "serve.batch"]["n"] == 2 * 2
        assert spans[under + "readback.wait"]["n"] == 2 * 2
        assert spans[under + "serve.batch/upload.copy"]["n"] == 2 * 2
        call = under + "serve.batch/predict.call"
        assert spans[call]["n"] == 2 * 2
        assert spans[call + "/predict.launch"]["n"] == 2 * 1


def _bn_norm(c, seed, dev, dtype):
    """(mean, var, weight, bias, eps) of a BatchNorm with drawn values, in
    ``dtype`` as a serving copy of the model holds them."""
    r = np.random.default_rng(seed)
    vals = [r.normal(size=c), r.uniform(0.1, 2.0, size=c), r.normal(size=c),
            r.normal(size=c)]
    return tuple(torch.from_numpy(v.astype(np.float32)).to(dev, dtype)
                 for v in vals) + (1e-5,)


def _cl_at(x, misalign):
    """x as channels_last; with ``misalign``, at one element past a 16-byte
    boundary (the kernel's element route)."""
    x = x.contiguous(memory_format=CL)
    if not misalign:
        return x
    n, c, h, w = x.shape
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    out = base.as_strided(x.shape, (h * w * c, 1, w * c, c))
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,res,relu,misalign", [
    ((8, 64, 256, 256), "none", True, False),          # the sweep's stem
    ((8, 256, 128, 128), "identity", True, False),     # layer1's block end
    ((8, 256, 128, 128), "downsample", True, False),   # layer1's first block
    ((8, 2048, 32, 32), "downsample", True, False),    # layer4's first block
    ((288, 1024, 32, 32), "identity", True, False),    # a sweep batch, layer3
    ((288, 512, 1, 1), "none", True, False),           # the PPM's pooled maps
    ((288, 512, 2, 2), "none", True, False),
    ((288, 512, 3, 3), "none", True, False),
    ((288, 512, 6, 6), "none", True, False),
    ((3, 7, 9, 11), "downsample", False, False),       # odd C: element route
    ((2, 36, 5, 5), "identity", True, False),          # C % 8 = 4
    ((2, 64, 5, 5), "identity", False, True),          # misaligned pointers
])
def test_bnact_kernel(dev, dtype, shape, res, relu, misalign):
    """The eval BatchNorm epilogue against its plain version on the card:
    bf16 within one bf16 unit in the last place of the larger result (both
    round the f32 result once; the f32 arithmetic differs in the fused
    multiply-adds), f32 to 1e-5 relative and 1e-4 absolute; channels_last
    out, one launch."""
    from uemda_tpu_torch.ops.bnact import bnact, bnact_plain

    c = shape[1]
    x = _cl_at(_randn(shape, 1, dev, dtype, scale=3.0), misalign)
    norm = _bn_norm(c, 2, dev, dtype)
    r = None if res == "none" else _cl_at(_randn(shape, 3, dev, dtype),
                                          misalign)
    rnorm = _bn_norm(c, 4, dev, torch.float32) if res == "downsample" \
        else None
    n = bnact.launches
    got = bnact(x, norm, relu, r, rnorm)
    assert bnact.launches == n + 1
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    want = bnact_plain(x, norm, relu, r, rnorm)
    g, w = got.float(), want.float()
    if dtype == torch.bfloat16:
        tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-4
    else:
        tol = 1e-5 * w.abs() + 1e-4   # terms up to ~150: an f32 ulp 1.5e-5
    bad = int(((g - w).abs() > tol).sum())
    assert bad == 0, (bad, float((g - w).abs().max()))


def test_bnact_refuses_what_it_does_not_take(dev):
    from uemda_tpu_torch.ops.bnact import bnact

    x = _randn((2, 32, 4, 4), 1, dev, torch.bfloat16).contiguous(
        memory_format=CL)
    norm = _bn_norm(32, 2, dev, torch.bfloat16)
    n = bnact.launches
    with pytest.raises(ValueError, match="channels_last"):
        bnact(x.contiguous(), norm)
    with pytest.raises(ValueError, match="does not match"):
        bnact(x, norm, residual=x.float().contiguous(memory_format=CL))
    with pytest.raises(ValueError, match="contiguous f32 or bf16"):
        bnact(x, _bn_norm(16, 2, dev, torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous f32 or bf16"):
        bnact(x, tuple(t.cpu() for t in norm[:4]) + (1e-5,))
    assert bnact.launches == n


def test_standard_eval_forward_with_bnact_equals_the_library_path(dev):
    """The flagship (ResNet-50 OS16, dual PPM) eval forward: under
    ``no_grad`` every BatchNorm epilogue is one ``bnact`` launch (59 a
    forward); with gradients on, the library's calls and no launch. In f32
    the two equal at the eval gate, rtol 1e-3 and atol 2e-4; in bf16 the
    epilogue's probabilities, rounded once where the library rounds twice,
    lie no farther from the f32 forward's on average than the library's
    (5% of room)."""
    from uemda_tpu_torch.ops.bnact import bnact

    model = DeeplabV2(DeeplabV2Config.uemda_default(6),
                      generator=torch.Generator().manual_seed(0)).eval()
    x = _randn((2, 3, 128, 128), 5, dev, torch.float32).contiguous(
        memory_format=CL)
    probs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model.to(dtype)
        n = bnact.launches
        with torch.no_grad():
            probs[dtype, "bnact"] = model(x.to(dtype)).float()
        assert bnact.launches == n + 59
        probs[dtype, "library"] = model(x.to(dtype)).detach().float()
        assert bnact.launches == n + 59
    torch.cuda.synchronize()
    f32 = probs[torch.float32, "bnact"]
    np.testing.assert_allclose(
        f32.cpu().numpy(), probs[torch.float32, "library"].cpu().numpy(),
        rtol=1e-3, atol=2e-4)
    err = {k: float((probs[torch.bfloat16, k] - f32).abs().mean())
           for k in ("bnact", "library")}
    assert err["bnact"] <= 1.05 * err["library"], err


def test_captured_standard_predictor_holds_59_bnact_launches(dev):
    """The standard bf16 forward (ResNet-50 OS16, dual PPM) through the
    captured slide + TTA predictor: a replay holds 59 ``bnact`` launches
    (stem 1, 16 blocks x 3, two heads x 5) and equals eager calls within
    2e-4."""
    from uemda_tpu_torch.infer.slide import make_predictor

    net = DeeplabV2(DeeplabV2Config.uemda_default(6),
                    generator=torch.Generator().manual_seed(0)).eval() \
        .to(torch.bfloat16)
    kw = dict(tile=(64, 64), image_hw=(96, 96), tta=True,
              compute_dtype=torch.bfloat16)
    eager = make_predictor(net, capture=False, **kw)
    graph = make_predictor(net, **kw)
    for seed in (1, 2):
        x = _randn((2, 3, 96, 96), seed, dev, torch.float32)
        ref = eager(x)
        got = graph(x)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 2e-4, seed
    st = graph.close()
    assert st["replays"] == 1 and st["launches"]["bnact"] == 59, st

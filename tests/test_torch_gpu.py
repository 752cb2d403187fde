"""The port's CUDA kernels on the card, against their plain versions: the
odd shapes, both dtypes and both instance-norm routes (forward and
backward) that chip_smoke.py's shapes do not reach, the crop kernel's
vector and element routes (with and without the clamp), both routes of the
segment kernels, the mining kernel in every layout and branch, training
steps that go through the kernels, and the card as the entry points'
default.

These tests need an NVIDIA GPU and skip without one. They import neither JAX
nor the JAX package, so they run where only PyTorch is installed; the
repository's conftest imports JAX, so on such a machine run::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.ops.crop import crop_normalize, crop_normalize_plain
from uemda_tpu_torch.ops.insnorm import (
    instance_norm,
    instance_norm_backward,
    instance_norm_backward_plain,
    instance_norm_forward,
    instance_norm_forward_plain,
    instance_norm_plain,
)
from uemda_tpu_torch.ops.mine import uvem_mine, uvem_mine_plain
from uemda_tpu_torch.ops.segment import (
    segment_gather,
    segment_gather_plain,
    segment_max,
    segment_max_plain,
    segment_sum,
    segment_sum_bound,
    segment_sum_plain,
)
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
                                   (3, 2048, 32, 32), (2, 64, 9, 7)])
def test_instance_norm_backward_kernel(dev, dtype, shape):
    """The K1 backward against its plain version on the forward kernel's
    statistics (which match the plain statistics to 1e-5): the
    shared-memory route (bf16 up to 32x32) and the global-memory one (f32
    at 32x32, both at 64x64); f32 1e-5, bf16 1e-2 (test_pallas_insnorm.py)."""
    x = _randn(shape, 11, dev, dtype, shift=3.0).contiguous(memory_format=CL)
    dy = _randn(shape, 12, dev, dtype).contiguous(memory_format=CL)
    y, mean, rstd = instance_norm_forward(x)
    y_ref, mean_ref, rstd_ref = instance_norm_forward_plain(x)
    _close(y, y_ref, dtype)
    for got, ref in ((mean, mean_ref), (rstd, rstd_ref)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    n = instance_norm_backward.launches
    dx = instance_norm_backward(x, dy, mean, rstd)
    assert instance_norm_backward.launches == n + 1
    assert dx.is_contiguous(memory_format=CL)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    ref = instance_norm_backward_plain(x, dy, mean, rstd)
    torch.cuda.synchronize()
    np.testing.assert_allclose(dx.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=tol, rtol=tol)


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
    # ... and a table over the 227 KB of shared memory: global atomics
    (2, 128, 128, 7, 2, 5000),
])
def test_segment_kernels(dev, ids_dtype, case):
    """K5 and K7 exact against their plain versions; K6 exact on one-hot
    counts and, on random values, within the error bound of f32 summation
    in any order of the exact sums (its atomics' order varies); out-of-range
    ids (>= S, and negative) left out of both reductions and gathered back
    as NaN."""
    b, h, w, c, cell, extra = case
    sup, s = _grid_sup(b, h, w, cell, seed=c)
    s += extra
    sup[0, 0, :3] = [s, s + 7, -2]           # out of range
    ids = torch.from_numpy(sup.reshape(b, -1)).to(dev, ids_dtype)
    r = np.random.default_rng(h)
    val = torch.from_numpy(r.normal(size=(b, h * w, c)).astype(np.float32)).to(dev)
    n5, n6, n7 = segment_max.launches, segment_sum.launches, segment_gather.launches
    got = segment_max(val, ids, s)
    assert segment_max.route == ("global" if extra > 1000 else "shared")
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
    assert torch.equal(torch.nan_to_num(g, nan=7.0),
                       torch.nan_to_num(gref, nan=7.0))
    assert torch.isnan(g[0, :3]).all() and not torch.isnan(g[0, 3:]).any()
    assert (segment_max.launches, segment_sum.launches,
            segment_gather.launches) == (n5 + 1, n6 + 2, n7 + 1)


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

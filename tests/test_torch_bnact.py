"""The eval-mode BatchNorm epilogue (``ops/bnact.py``) on the CPU: its plain
version against the module math it replaces (``F.batch_norm`` in f32,
rounded to the input dtype, the residual added, ReLU), the standard eval
forward that now takes it against the JAX reference, and the routes that
keep the library's calls (train mode, frozen BatchNorm under autograd)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_helpers import models_from_port, to_nhwc, to_torch
from uemda_tpu_torch.models import resnet
from uemda_tpu_torch.models.resnet import (
    BatchNorm,
    bn_act,
    bn_norm,
    conv,
    epilogue_applies,
)
from uemda_tpu_torch.ops.bnact import bnact, bnact_plain

CL = torch.channels_last


def _bn(c, seed, dtype=torch.float32):
    """An eval-mode BatchNorm with drawn statistics and affine parameters."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.1)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g))
    return bn.eval().to(dtype)


def _x(shape, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3).to(dtype) \
        .contiguous(memory_format=CL)


def _library(x, bn, relu, residual=None, residual_bn=None):
    """The chain the epilogue replaces: f32 BatchNorm rounded to x's dtype,
    the residual (through its own BatchNorm, rounded) added in x's dtype,
    then ReLU."""
    def norm(t, m):
        return F.batch_norm(t.float(), m.running_mean.float(),
                            m.running_var.float(), m.weight.float(),
                            m.bias.float(), False, 0.0, m.eps).to(t.dtype)

    y = norm(x, bn)
    if residual is not None:
        y = y + (residual if residual_bn is None else norm(residual,
                                                           residual_bn))
    return F.relu(y) if relu else y


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("res", ["none", "identity", "downsample"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 7, 5, 3), (2, 64, 6, 5),
                                   (1, 2048, 3, 2), (2, 512, 1, 1)])
def test_plain_equals_the_library_chain(dtype, res, relu, shape):
    """Within the rounding the chain does and the epilogue does not: f32
    bit for bit, bf16 to two bf16 ulps of the larger of the terms (the
    chain rounds BatchNorm's output and then the sum, the epilogue once);
    the layout is kept."""
    c = shape[1]
    x = _x(shape, 1, dtype)
    bn = _bn(c, 2, dtype)
    r = None if res == "none" else _x(shape, 3, dtype)
    rbn = _bn(c, 4, dtype) if res == "downsample" else None
    with torch.no_grad():
        got = bnact(x, bn_norm(bn), relu, r,
                    None if rbn is None else bn_norm(rbn))
        want = _library(x, bn, relu, r, rbn)
    assert got.dtype == dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=CL)
    diff = (got.float() - want.float()).abs()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    # the scale of each output: |bn(x)| and |residual term|
    mag = _library(x, bn, False).float().abs()
    if r is not None:
        mag = mag + (r.float().abs() if rbn is None
                     else _library(r, rbn, False).float().abs())
    assert bool((diff <= 2 * ulp * mag + 1e-6).all()), float(
        (diff / (mag + 1e-6)).max())
    if dtype == torch.float32:
        # no rounding to a storage type between the stages: the chain's
        # arithmetic, bit for bit
        assert torch.equal(got, want)


def test_plain_rounds_once():
    """bf16: the epilogue is the f32 result rounded once, where the chain
    rounds the BatchNorm's output first."""
    x = _x((2, 64, 4, 4), 5, torch.bfloat16)
    r = _x((2, 64, 4, 4), 6, torch.bfloat16)
    bn = _bn(64, 7, torch.bfloat16)
    with torch.no_grad():
        got = bnact_plain(x, bn_norm(bn), True, r)
        f32 = bnact_plain(x.float(), bn_norm(bn), True, r.float())
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_bn_params_in_mixed_dtypes():
    """bf16 affine parameters with f32 running statistics (a compute copy
    of the parameters) read as the library reads them: in f32."""
    x = _x((2, 32, 3, 3), 8, torch.float32)
    bn = _bn(32, 9)
    with torch.no_grad():
        bn.weight.data = bn.weight.data.to(torch.bfloat16)
        bn.bias.data = bn.bias.data.to(torch.bfloat16)
        got = bn_act(bn, x)
        want = F.relu(bn(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_refuses_a_tensor_on_no_device_it_runs_on():
    x = torch.empty(1, 32, 4, 4, device="meta").contiguous(memory_format=CL)
    s = torch.zeros(32, device="meta")
    before = bnact.launches
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        bnact(x, (s, s, s, s, 1e-5))
    with pytest.raises(ValueError, match="without a residual"):
        bnact(x, (s, s, s, s, 1e-5), residual_norm=(s, s, s, s, 1e-5))
    assert bnact.launches == before


def test_applies_only_on_running_statistics_without_gradients():
    """The epilogue is taken in eval mode or with ``frozen`` BatchNorm when
    no gradient is wanted; train mode, and anything that wants a gradient
    (a downsample conv's weight too), keep the library's calls."""
    applies = epilogue_applies
    x = _x((2, 16, 3, 3), 10, torch.float32)
    bn = _bn(16, 11)
    assert not applies((bn,), (x,))                  # its parameters want grad
    with torch.no_grad():
        assert applies((bn,), (x,))
    bn.train()
    with torch.no_grad():
        assert not applies((bn,), (x,))              # batch statistics
    bn.frozen = True
    with torch.no_grad():
        assert applies((bn,), (x,))
    assert not applies((bn,), (x,))                  # its parameters want grad
    bn.requires_grad_(False)
    assert applies((bn,), (x,))
    assert not applies((bn,), (x.requires_grad_(),))
    x = x.detach()
    ds = torch.nn.Sequential(conv(16, 16, 1), _bn(16, 12))
    ds[1].requires_grad_(False)
    assert not applies((bn, ds), (x, x))             # the conv wants grad
    ds[0].requires_grad_(False)
    assert applies((bn, ds), (x, x))
    ds.train()
    assert not applies((bn, ds), (x, x))             # its batch statistics


def _flagship_like(seed=0):
    """ResNet-50 dual-PPM (the flagship's modules) from the port's seeded
    init with drawn BatchNorm statistics, and its JAX twin."""
    return models_from_port("resnet50", seed=seed)


def test_eval_forward_takes_the_epilogue_and_equals_jax():
    """The standard eval forward under ``no_grad`` runs every BatchNorm
    through the epilogue and equals the JAX eval forward at the eval gate
    (rtol 1e-3, atol 2e-4, f32); with gradients on (the library's calls)
    it equals the same forward bit for bit."""
    import jax
    import jax.numpy as jnp

    jmodel, variables, tmodel = _flagship_like()
    x = np.random.default_rng(3).normal(size=(1, 32, 32, 3)).astype(np.float32)
    # jitted: one XLA compile costs less than the eager apply's op-by-op ones
    ref = np.asarray(jax.jit(lambda v, t: jmodel.apply(v, t, train=False))(
        variables, jnp.asarray(x)))
    calls = []
    real = resnet._bnact.bnact

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    resnet._bnact.bnact = counted
    try:
        with torch.no_grad():
            got = tmodel(to_torch(x))
        lib = tmodel(to_torch(x)).detach()    # parameters want grad
    finally:
        resnet._bnact.bnact = real
    # stem 1 + 16 blocks x 3 + two heads x (4 pooled branches + conv_last)
    assert len(calls) == 59
    np.testing.assert_allclose(to_nhwc(got), ref, rtol=1e-3, atol=2e-4)
    assert torch.equal(got, lib)


@pytest.mark.parametrize("frozen", [False, True])
def test_train_forward_keeps_the_library_calls(frozen):
    """Train mode (batch statistics), and frozen BatchNorm under autograd,
    never take the epilogue."""
    from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config

    cfg = DeeplabV2Config.uemda_default(6, resnet_type="resnet18")
    model = DeeplabV2(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0)).train()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.frozen = frozen
    calls = []
    real = resnet._bnact.bnact
    resnet._bnact.bnact = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = model(_x((2, 3, 32, 32), 12, torch.float32))
        sum(o.float().sum() for o in out).backward()
    finally:
        resnet._bnact.bnact = real
    assert calls == []


def test_launcher_arguments_match_the_c_signature():
    """The wrapper hands ``uemda_bnact`` as many ctypes arguments as
    ``bnact.cu`` declares, of the same kinds (pointer, 64-bit, int,
    float)."""
    import re
    from pathlib import Path

    from uemda_tpu_torch import kernels
    from uemda_tpu_torch.ops import bnact as op

    src = (Path(kernels.__file__).with_name("csrc") / "bnact.cu").read_text()
    sig = re.search(r'extern "C" int uemda_bnact\((.*?)\)\s*\{', src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    kinds = [kernels.P if "*" in p else kernels.L if "long long" in p
             else kernels.F if p.startswith("float") else kernels.I
             for p in params]
    assert kinds == op._ARGS

"""The fused identity bottleneck (K4) of the port against the JAX package, on
the CPU: ``bottleneck_identity`` (its plain version, which a CPU tensor
takes) against ``bottleneck_identity_pallas`` in interpret mode, and the
port's fast path with ``fused_stages`` against the JAX fast path with
``fused_stages``. The inputs are drawn with numpy and handed to both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, no_tf32, to_nhwc, to_torch
from uemda_tpu.infer.fastpath import make_serving_fn as jax_make_serving_fn
from uemda_tpu.ops.pallas_resblock import bottleneck_identity_pallas
from uemda_tpu_torch.infer import fastpath
from uemda_tpu_torch.infer.fastpath import build_serving_params, make_serving_fn
from uemda_tpu_torch.ops.resblock import bottleneck_identity

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _make(seed, b=2, h=16, w=16, cin=32, cmid=8):
    """tests/test_pallas_resblock.py:_make: x (B, H, W, C), HWIO weights
    (x 0.2), f32 biases, as numpy f32."""
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32) * k for s, k in (
        ((b, h, w, cin), 1.0), ((1, 1, cin, cmid), 0.2), ((cmid,), 1.0),
        ((3, 3, cmid, cmid), 0.2), ((cmid,), 1.0), ((1, 1, cmid, cin), 0.2),
        ((cin,), 1.0))]


def _port_args(args, dtype):
    """The same arrays for the port: x channels_last, OIHW weights in the
    dtype (channels_last), f32 biases."""
    x, w1, b1, w2, b2, w3, b3 = args

    def wt(w):
        return torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(dtype) \
            .contiguous(memory_format=torch.channels_last)

    return (to_torch(x, dtype), wt(w1), torch.from_numpy(b1), wt(w2),
            torch.from_numpy(b2), wt(w3), torch.from_numpy(b3))


# (seed, shape overrides, band rows, dilation, dtype, tolerance): the cases
# of tests/test_pallas_resblock.py -- one band, 2 and 4 bands, dilation 2
# at one band, the band == dil edge and interior bands, bf16 (its 1.6e-2
# covers the 3x3's tap order, one bf16 ulp), f32 at 1e-5 -- and an odd
# shape whose sides are not multiples of a band
CASES = {
    "single-band": (0, {}, 16, 1, torch.float32, 1e-5),
    "multi-band-8": (1, {}, 8, 1, torch.float32, 1e-5),
    "multi-band-4": (1, {}, 4, 1, torch.float32, 1e-5),
    "dilated-16": (4, {}, 16, 2, torch.float32, 1e-5),
    "dilated-8": (4, {}, 8, 2, torch.float32, 1e-5),
    "dilated-2": (4, {}, 2, 2, torch.float32, 1e-5),
    "bf16": (3, {}, 8, 1, torch.bfloat16, 1.6e-2),
    "odd-1x24x13x11": (5, dict(b=1, h=13, w=11, cin=24, cmid=8), 13, 1,
                       torch.float32, 1e-5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bottleneck_identity_matches_pallas(case):
    seed, shape, rows, dil, dtype, tol = CASES[case]
    args = _make(seed, **shape)
    jargs = [jnp.asarray(a, JDT[dtype]) if i in (0, 1, 3, 5) else jnp.asarray(a)
             for i, a in enumerate(args)]
    want = np.asarray(bottleneck_identity_pallas(*jargs, band_rows=rows,
                                                 dilation=dil), np.float32)
    got = bottleneck_identity(*_port_args(args, dtype), dilation=dil)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=tol, atol=tol)


def test_bottleneck_identity_refuses_what_does_not_fuse():
    """A block _fusable would not admit raises ValueError: Cin != Cout, a
    middle conv that is not 3x3, int8 weights, dilation 0."""
    x, w1, b1, w2, b2, w3, b3 = _port_args(_make(0), torch.float32)
    bottleneck_identity(x, w1, b1, w2, b2, w3, b3)
    with pytest.raises(ValueError, match="Cin == Cout"):
        bottleneck_identity(x, w1, b1, w2, b2, w3[:16], b3[:16])
    with pytest.raises(ValueError, match="3x3"):
        bottleneck_identity(x, w1, b1, w2[:, :, :1, :1], b2, w3, b3)
    with pytest.raises(ValueError, match="int8"):
        bottleneck_identity(x, w1, b1, w2.to(torch.int8), b2, w3, b3)
    with pytest.raises(ValueError, match="dilation"):
        bottleneck_identity(x, w1, b1, w2, b2, w3, b3, dilation=0)


def test_fused_fastpath_matches_jax_fused_fastpath():
    """make_serving_fn(fused_stages=(1, 2), s2b off) against the JAX
    make_serving_fn(fused_stages=(1, 2), fused_stem=True) on the same
    ported weights: ResNet-50 OS16 at 32x32, f32, atol 2e-6 and rtol 2e-5
    as tests/test_pallas_resblock.py:83-110. The forward goes through the
    K4 wrapper five times (two identity blocks of layer1, three of
    layer2)."""
    no_tf32()
    jmodel, variables, tmodel = jax_and_torch_models("resnet50", hw=32, seed=21)
    x = np.random.default_rng(2).normal(size=(1, 32, 32, 3)).astype(np.float32)
    jfn, jparams = jax_make_serving_fn(jmodel, variables, dtype=jnp.float32,
                                       fused_stages=(1, 2), fused_stem=True,
                                       s2b_layer4=False)
    want = np.asarray(jfn(jparams, jnp.asarray(x)))
    fn, params = make_serving_fn(tmodel, dtype=torch.float32,
                                 fused_stages=(1, 2), s2b_layer4=False)
    calls = []
    real = fastpath.bottleneck_identity
    fastpath.bottleneck_identity = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        with torch.no_grad():
            got = to_nhwc(fn(params, to_torch(x)))
    finally:
        fastpath.bottleneck_identity = real
    assert calls == [{"dilation": 1}] * 5
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_fusable_refuses_int8_entries_and_first_blocks():
    """Stages listed in both fused_stages and int8_stages keep their blocks
    on _block_forward: _fusable sees the 'wq' entry. A first block (with its
    downsample branch) never fuses; a BasicBlock net has nothing to fuse."""
    _, _, tmodel = jax_and_torch_models("resnet50", hw=32, seed=21)
    meta, params = build_serving_params(tmodel, dtype=torch.float32,
                                        int8_stages=(1,), fused_stages=(1, 2))
    l1, l2 = params["layer1"], params["layer2"]
    assert "wq" in l1[1]["conv2"]
    assert not any(fastpath._fusable(b, meta, 1) for b in l1)
    assert not fastpath._fusable(l2[0], meta, 1)
    assert all(fastpath._fusable(b, meta, 1) for b in l2[1:])
    calls = []
    real = fastpath.bottleneck_identity
    fastpath.bottleneck_identity = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        with torch.no_grad():
            fastpath.serving_forward(meta, params, torch.zeros(1, 3, 32, 32))
    finally:
        fastpath.bottleneck_identity = real
    assert len(calls) == 3
    _, _, r18 = jax_and_torch_models("resnet18", hw=32, seed=3)
    meta18, p18 = build_serving_params(r18, dtype=torch.float32,
                                       fused_stages=(1, 2, 3, 4))
    assert not any(fastpath._fusable(b, meta18, 1) for li in range(1, 5)
                   for b in p18[f"layer{li}"])

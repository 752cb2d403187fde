"""The port's weights, eval model and serving fast path against the JAX
package, f32 on the CPU: ``state_dict_from_jax`` against
``export_deeplabv2``, ``DeeplabV2`` against ``DeeplabV2.apply(train=False)``
and ``serving_forward`` against ``make_serving_fn``. The inputs are drawn
with numpy and handed to both."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, no_tf32, to_nhwc, to_torch
from uemda_tpu.infer.fastpath import make_serving_fn as jax_make_serving_fn
from uemda_tpu.models.port_torch import export_deeplabv2
from uemda_tpu_torch.infer.fastpath import (
    build_fastpath,
    check_fastpath_tile,
    make_serving_fn,
)
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.models.config import BackboneConfig
from uemda_tpu_torch.models.port import load_checkpoint, save_npz, state_dict_from_jax
from uemda_tpu_torch.models.resnet import ResNet
from uemda_tpu_torch.ops.insnorm import instance_norm
from uemda_tpu_torch.ops.stem import stem_pool
from uemda_tpu_torch.ops.tail import tail_upsample_softmax_mean

# (resnet, config overrides): dual, cascade and single-head PPM, and ASPP
BRANCHES = {
    "resnet50-dual": ("resnet50", {}),
    "resnet18-cascade": ("resnet18", {"cascade": True}),
    "resnet18-single": ("resnet18", {"multi_layer": False}),
    "resnet18-aspp": ("resnet18", {"use_ppm": False}),
}


@functools.lru_cache(maxsize=None)
def _models(branch, hw=64):
    resnet, overrides = BRANCHES[branch]
    return jax_and_torch_models(resnet, hw=hw, seed=len(branch), **overrides)


@functools.lru_cache(maxsize=None)
def _case(branch, hw=64, batch=2):
    """(JAX model, variables, port model, input NHWC, JAX eval output)."""
    jmodel, variables, tmodel = _models(branch, hw)
    x = np.random.default_rng(7).normal(size=(batch, hw, hw, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    return jmodel, variables, tmodel, x, ref


@pytest.mark.parametrize("branch", ["resnet18-cascade", "resnet18-aspp"])
def test_state_dict_from_jax_matches_export(branch):
    """Key for key, value for value, the port's converter equals the JAX
    package's exporter (PPM and ASPP heads); the state dict loads into the
    port's model."""
    _, variables, tmodel = _models(branch)
    use_ppm = tmodel.config.use_ppm
    got = state_dict_from_jax(variables, use_ppm=use_ppm)
    want = export_deeplabv2(variables, use_ppm=use_ppm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert sorted(tmodel.state_dict()) == sorted(want)


def test_checkpoint_files_roundtrip(tmp_path):
    """The port's .npz and a reference-style .pth (torch.save of the state
    dict, optionally under 'state_dict') load back to the same tensors."""
    tmodel = _models("resnet18-single", 64)[2]
    sd = tmodel.state_dict()
    npz = save_npz(str(tmp_path / "w.npz"), sd)
    torch.save({"state_dict": sd}, str(tmp_path / "w.pth"))
    for path in (npz, str(tmp_path / "w.pth")):
        back = load_checkpoint(path)
        assert sorted(back) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), (path, k)
    model = DeeplabV2(tmodel.config, device="cpu")
    model.load_state_dict(load_checkpoint(npz))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_eval_forward_matches_jax(branch):
    """Averaged head softmax at input resolution, f32 (TF32 off, stated for
    the card): rtol 1e-3, atol 2e-4 as test_model_parity.py:217."""
    no_tf32()
    _, _, tmodel, x, ref = _case(branch)
    with torch.no_grad():
        got = to_nhwc(tmodel(to_torch(x)))
    assert got.shape == ref.shape == (2, 64, 64, 6)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("s2b", [True, False])
def test_serving_forward_matches_jax_fastpath(s2b):
    """The port's fast path (its stem is always the fused K2 stem) against
    the JAX make_serving_fn with fused_stem=True, f32, both s2b settings:
    atol 5e-5, rtol 1e-4 as test_infer_fastpath.py:47; argmax agrees on
    > 99.9% of pixels."""
    no_tf32()
    jmodel, variables, tmodel, x, _ = _case("resnet50-dual")
    jfn, jparams = jax_make_serving_fn(jmodel, variables, dtype=jnp.float32,
                                       fused_stem=True, s2b_layer4=s2b)
    want = np.asarray(jfn(jparams, jnp.asarray(x)))
    fn, params = make_serving_fn(tmodel, dtype=torch.float32, s2b_layer4=s2b)
    with torch.no_grad():
        got = to_nhwc(fn(params, to_torch(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999


@pytest.mark.parametrize("branch",
                         ["resnet18-cascade", "resnet18-single", "resnet18-aspp"])
def test_serving_forward_other_branches_match_eval(branch):
    """Cascade (two head groups), single-head and ASPP fast paths against
    the JAX eval forward: atol 5e-5, rtol 1e-4."""
    no_tf32()
    _, _, tmodel, x, ref = _case(branch)
    fn, params = make_serving_fn(tmodel, dtype=torch.float32)
    with torch.no_grad():
        got = to_nhwc(fn(params, to_torch(x)))
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


def test_serving_forward_stem_at_sides_not_divisible_by_4():
    """A 30x30 input: the space-to-depth map is 15x15 and the fused stem
    pools it to 8x8 (the JAX fast path falls back to its unfused stem here;
    the port has one stem). Against the JAX eval forward, f32: atol 5e-5,
    rtol 1e-4 as test_infer_fastpath.py:178."""
    no_tf32()
    jmodel, variables, tmodel = _models("resnet18-single")
    x = np.random.default_rng(8).normal(size=(1, 30, 30, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    fn, params = make_serving_fn(tmodel, dtype=torch.float32)
    with torch.no_grad():
        got = to_nhwc(fn(params, to_torch(x)))
    assert got.shape == ref.shape == (1, 30, 30, 6)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


def test_serving_forward_bf16_matches_jax_bf16_fastpath():
    """The serving dtype: the port's bf16 fast path (the build_fastpath
    setting, s2b off) against the JAX make_serving_fn(dtype=bfloat16,
    fused_stem=True) on the same weights and input, and against the f32 eval
    forward. Bound of test_infer_fastpath.py:204-205: rows sum to 1 within
    2e-2, mean abs diff < 0.03."""
    no_tf32()
    jmodel, variables, tmodel, x, ref = _case("resnet50-dual")
    jfn, jparams = jax_make_serving_fn(jmodel, variables, dtype=jnp.bfloat16,
                                       fused_stem=True)
    want = np.asarray(jfn(jparams, jnp.asarray(x, jnp.bfloat16)), np.float32)
    fn, params = make_serving_fn(tmodel, dtype=torch.bfloat16)
    with torch.no_grad():
        got = to_nhwc(fn(params, to_torch(x, torch.bfloat16)))
    assert got.shape == want.shape == ref.shape
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=2e-2)
    assert np.abs(got - want).mean() < 0.03
    assert np.abs(got - ref).mean() < 0.03


def test_serving_path_goes_through_every_kernel_wrapper():
    """One fast-path forward calls each kernel's wrapper once
    (on the CPU the wrappers take their plain versions and count nothing);
    the standard forward calls K1 and K3."""
    tmodel = _models("resnet18-single", 64)[2]
    calls = {}

    def spy(fn):
        def wrapped(*a, **k):
            calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
            return fn(*a, **k)
        return wrapped

    import uemda_tpu_torch.infer.fastpath as fp
    import uemda_tpu_torch.models.deeplabv2 as dl

    fast = build_fastpath(tmodel, dtype=torch.float32)
    x = to_torch(np.zeros((1, 64, 64, 3), np.float32))
    saved = (fp.instance_norm, fp.stem_pool, dl.instance_norm,
             dl.tail_upsample_softmax_mean)
    try:
        fp.instance_norm, fp.stem_pool = spy(instance_norm), spy(stem_pool)
        dl.instance_norm = spy(instance_norm)
        dl.tail_upsample_softmax_mean = spy(tail_upsample_softmax_mean)
        with torch.no_grad():
            fast(x)
            assert calls == {"instance_norm": 1, "stem_pool": 1,
                             "tail_upsample_softmax_mean": 1}
            tmodel(x)
    finally:
        (fp.instance_norm, fp.stem_pool, dl.instance_norm,
         dl.tail_upsample_softmax_mean) = saved
    assert calls == {"instance_norm": 2, "stem_pool": 1,
                     "tail_upsample_softmax_mean": 2}


def test_later_slices_raise():
    """What is not a valid configuration raises instead of running something
    else: an unknown source loss, an accumulation of fewer than one step,
    an unknown backbone, odd fast-path sizes. (OHEM, accumulation,
    ResNeXt and v1c, class balance, int8 serving and fused_stages are
    ported: the first four build here, ``test_torch_backbones.py`` and
    ``test_torch_zoo_steps.py`` hold them to JAX.)"""
    from uemda_tpu_torch.train.optim import SGD
    from uemda_tpu_torch.train.steps import StageHParams, make_src_step

    tmodel = _models("resnet18-single", 64)[2]
    dual = DeeplabV2(DeeplabV2Config.uemda_default(6, resnet_type="resnet18"),
                     device="cpu")
    with pytest.raises(ValueError, match="source_loss"):
        make_src_step(dual, StageHParams(class_num=6, source_loss="dice"))
    make_src_step(dual, StageHParams(class_num=6, source_loss="ohem"))
    make_src_step(dual, StageHParams(class_num=6, balance_source=True))
    with pytest.raises(ValueError, match="accum"):
        SGD(list(dual.named_parameters()), lambda step: 0.0, accum_steps=0)
    assert SGD(list(dual.named_parameters()), lambda step: 0.0,
               accum_steps=2).accum_steps == 2
    with pytest.raises(KeyError):
        ResNet(BackboneConfig(resnet_type="resnet49"))
    assert ResNet(BackboneConfig(resnet_type="resnext50_32x4d")) \
        .layer1[0].conv2.groups == 32
    assert len(ResNet(BackboneConfig(resnet_type="resnet50_v1c")).stem) == 9
    fn, params = make_serving_fn(tmodel, dtype=torch.float32, s2b_layer4=True)
    with pytest.raises(ValueError, match="divisible by 32"):
        fn(params, torch.zeros(1, 3, 48, 48))
    with pytest.raises(SystemExit):
        check_fastpath_tile((511, 512))
    check_fastpath_tile((512, 512))
    assert isinstance(DeeplabV2Config.uemda_default(6), DeeplabV2Config)

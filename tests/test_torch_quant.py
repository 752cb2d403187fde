"""int8 serving of the port against the JAX package, on the CPU: the weight
quantization, the int8 conv, the int8 fast path (heads + stages),
activation-scale calibration and its contracts, ``Int8Model`` on the
standard forward, the ``--int8-stages`` guard and the eval CLI's int8
flags. The inputs are drawn with numpy and handed to both."""

import functools
import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tests.torch_port_helpers import jax_and_torch_models, no_tf32, to_nhwc, to_torch
from uemda_tpu.infer import fastpath as jfp
from uemda_tpu.infer.quant import Int8Model as JaxInt8Model
from uemda_tpu_torch.infer import fastpath
from uemda_tpu_torch.infer.fastpath import (
    _conv_int8,
    _map_int8_entries,
    _quantize_w,
    build_fastpath,
    calibrate_act_scales,
    make_serving_fn,
    parse_int8_stages_flag,
)
from uemda_tpu_torch.infer.quant import Int8Model, int8_apply


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@functools.lru_cache(maxsize=None)
def _models(hw):
    """resnet18 dual PPM with seeded weights, the JAX eval output and the
    input, at hw x hw, batch 2."""
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", hw=hw, seed=5)
    x = _rand((2, hw, hw, 3), 13)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    return jmodel, variables, tmodel, x, ref


def _scales(tree, walk):
    out = []
    walk(tree, lambda e: out.append(float(e["a"])) or e)
    return np.asarray(out)


def test_quantize_w_bit_equal_to_jax():
    """The same int8 weights and per-out-channel scales, bit for bit (one
    channel all zero: the 1e-12 floor)."""
    w = _rand((3, 3, 24, 16), 0, 0.1)
    w[..., 5] = 0.0
    q_j, s_j = jfp._quantize_w(w)
    q, s = _quantize_w(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q.transpose(2, 3, 1, 0), np.asarray(q_j))
    np.testing.assert_array_equal(s, s_j)


@pytest.mark.parametrize("stride,dilation,static", [
    (1, 1, False), (2, 1, False), (1, 2, False), (1, 2, True), (2, 1, True)])
def test_conv_int8_matches_jax(stride, dilation, static):
    """_conv_int8 on equal inputs: dynamic per-tensor amax or a static
    scale (which saturates part of x), dilated and strided; rtol 1e-6."""
    x = _rand((2, 13, 11, 16), 1)
    w = _rand((3, 3, 16, 24), 2, 0.1)
    b = _rand((24,), 3)
    wq, s = jfp._quantize_w(w)
    a = np.float32(1.5 / 127.0) if static else None
    want = np.asarray(jfp._conv_int8(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s), jnp.asarray(b),
        stride=stride, dilation=dilation,
        a=None if a is None else jnp.asarray(a)))
    got = _conv_int8(to_torch(x), _oihw(wq), torch.from_numpy(s),
                     torch.from_numpy(b), stride=stride, dilation=dilation,
                     a=None if a is None else torch.tensor(a))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_nhwc(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stages,bound", [((3, 4), 0.02), ((1, 2, 3, 4), 0.03)])
def test_int8_fastpath_matches_jax(stages, bound):
    """heads_int8 + int8_stages on resnet18 at 64x64, f32: against the JAX
    int8 make_serving_fn (mean abs prob diff < 5e-3: int8 roundings flip
    where the two f32 convs differ in the last place), and against the exact
    forward with the bounds of tests/test_infer_fastpath.py:66-90."""
    no_tf32()
    jmodel, variables, tmodel, x, ref = _models(64)
    jfn, jparams = jfp.make_serving_fn(jmodel, variables, dtype=jnp.float32,
                                       heads_int8=True, int8_stages=stages)
    want = np.asarray(jfn(jparams, jnp.asarray(x)))
    fn, params = make_serving_fn(tmodel, dtype=torch.float32, heads_int8=True,
                                 int8_stages=stages)
    n_q = []
    _map_int8_entries(params, lambda e: n_q.append(e) or e)
    assert len(n_q) == len(stages) * 4 + 1   # four 3x3s a stage + last_feat
    with torch.no_grad():
        got = to_nhwc(fn(params, to_torch(x)))
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-3)
    assert np.abs(got - want).mean() < 5e-3
    assert np.abs(got - ref).mean() < bound


def test_calibrated_scales_match_jax():
    """calibrate_act_scales over two batches: the same static scales as the
    JAX package's, in the same order (rtol 1e-6). Calibrated on one batch
    and serving it, the forward stays close to the dynamic one
    (tests/test_infer_fastpath.py:127-140)."""
    no_tf32()
    jmodel, variables, tmodel, x, _ = _models(32)
    x2 = _rand((2, 32, 32, 3), 14, 2.0)
    jfpm, jparams = jfp.build_fastpath(jmodel, variables, dtype=jnp.float32,
                                       int8=True)
    jcal = jfp.calibrate_act_scales(jfpm.meta, jparams,
                                    [jnp.asarray(x), jnp.asarray(x2)])
    fpm = build_fastpath(tmodel, dtype=torch.float32, int8=True)
    cal = calibrate_act_scales(fpm.meta, fpm.params, [to_torch(x), to_torch(x2)])
    want = _scales(jcal, jfp._map_int8_entries)
    got = _scales(cal, _map_int8_entries)
    assert got.shape == want.shape == (9,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    cal = calibrate_act_scales(fpm.meta, fpm.params, [to_torch(x)])
    with torch.no_grad():
        dyn = to_nhwc(fpm(to_torch(x)))
        stat = to_nhwc(fastpath.serving_forward(fpm.meta, cal, to_torch(x)))
    np.testing.assert_allclose(stat.sum(-1), 1.0, atol=1e-3)
    assert np.abs(stat - dyn).mean() < 5e-3


def test_calibration_contracts():
    """No batch consumed (or no int8 site): the original params object comes
    back. Re-calibration drops the old scales. A visit count or a visit
    order that differs from the params walk raises AssertionError."""
    _, _, tmodel, x, _ = _models(32)
    xt = to_torch(x)
    fpm = build_fastpath(tmodel, dtype=torch.float32, int8=True)
    meta, params = fpm.meta, fpm.params
    assert calibrate_act_scales(meta, params, []) is params
    assert calibrate_act_scales(meta, params, iter(())) is params
    plain = build_fastpath(tmodel, dtype=torch.float32)
    assert calibrate_act_scales(plain.meta, plain.params, [xt]) is plain.params
    cal1 = calibrate_act_scales(meta, params, [xt])
    cal2 = calibrate_act_scales(meta, cal1, [xt * 3.0])
    fresh = calibrate_act_scales(meta, params, [xt * 3.0])
    np.testing.assert_array_equal(_scales(cal2, _map_int8_entries),
                                  _scales(fresh, _map_int8_entries))
    assert not np.array_equal(_scales(cal1, _map_int8_entries),
                              _scales(cal2, _map_int8_entries))
    hidden = {**params, "layer4": tuple(params["layer4"])}  # walk skips it
    with pytest.raises(AssertionError, match="visited 9 int8 convs but the "
                       "params hold 5"):
        calibrate_act_scales(meta, hidden, [xt])
    order = ["stem", "layer1", "layer2", "layer4", "layer3", "head_groups"]
    swapped = {k: params[k] for k in order}
    with pytest.raises(AssertionError, match="order mismatch"):
        calibrate_act_scales(meta, swapped, [xt])


class _OneConv(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Conv(5, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                        use_bias=True)(x)


class _GroupedConv(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Conv(8, (3, 3), padding=((1, 1), (1, 1)),
                        feature_group_count=4, use_bias=False)(x)


@pytest.mark.parametrize("case", ["strided-bias", "grouped"])
def test_int8_model_conv_matches_jax(case):
    """The cases of tests/test_infer_quant.py: one strided 3x3 with bias and
    one grouped 3x3, through Int8Model and the functional int8_apply, on the
    JAX module's weights; rtol and atol 1e-6."""
    if case == "strided-bias":
        jm, cin = _OneConv(), 3
        conv = torch.nn.Conv2d(3, 5, 3, 2, 1, bias=True)
    else:
        jm, cin = _GroupedConv(), 8
        conv = torch.nn.Conv2d(8, 8, 3, 1, 1, groups=4, bias=False)
    x = _rand((2, 8, 8, cin) if case == "strided-bias" else (2, 6, 6, 8), 7)
    variables = jm.init(jax.random.key(3), jnp.asarray(x))
    want = np.asarray(JaxInt8Model(jm).apply(variables, jnp.asarray(x)))
    p = variables["params"]["Conv_0"]
    with torch.no_grad():
        conv.weight.copy_(_oihw(np.asarray(p["kernel"])))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    model = torch.nn.Sequential(conv).eval()
    got = to_nhwc(Int8Model(model)(to_torch(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(to_nhwc(int8_apply(model, to_torch(x))), got)
    with torch.no_grad():
        f32 = to_nhwc(model(to_torch(x)))
    assert np.abs(got - f32).max() < 0.05 * np.abs(f32).max() + 1e-3
    assert not np.allclose(got, f32, atol=1e-7)


def test_int8_model_flagship_forward_matches_jax():
    """Int8Model on the eval forward of resnet18 dual PPM at 64x64 against
    the JAX Int8Model (mean abs prob diff < 5e-3) and against the exact
    forward with the bounds of tests/test_infer_quant.py:48-67, except the
    argmax agreement: on this draw (BatchNorm statistics randomized) the JAX
    Int8Model itself agrees with the exact forward on 93.1% of pixels, not
    > 95%, so the port is held to the JAX package's agreement less 0.005.
    It raises in train mode."""
    no_tf32()
    jmodel, variables, tmodel, x, ref = _models(64)
    want = np.asarray(JaxInt8Model(jmodel).apply(variables, jnp.asarray(x),
                                                 train=False))
    qm = Int8Model(tmodel)
    got = to_nhwc(qm(to_torch(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-3)
    assert np.abs(got - want).mean() < 5e-3
    assert np.abs(got - ref).mean() < 0.02
    agree = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert agree > (want.argmax(-1) == ref.argmax(-1)).mean() - 0.005
    assert qm.config is tmodel.config
    tmodel.train()
    try:
        with pytest.raises(ValueError, match="inference-only"):
            qm(to_torch(x))
    finally:
        tmodel.eval()
    with torch.no_grad():  # every conv's own forward is back
        np.testing.assert_allclose(to_nhwc(tmodel(to_torch(x))), ref,
                                   rtol=1e-3, atol=2e-4)


def test_parse_int8_stages_flag():
    assert parse_int8_stages_flag("", False, False) is None
    assert parse_int8_stages_flag("1,2,3,4", True, True) == (1, 2, 3, 4)
    assert parse_int8_stages_flag(" 3 , 4 ,", True, True) == (3, 4)
    for flag, int8, fast in (("3,4", True, False), ("3,4", False, True),
                             ("5", True, True), ("a,b", True, True),
                             (",", True, True), ("0,1", True, True)):
        with pytest.raises(SystemExit):
            parse_int8_stages_flag(flag, int8, fast)


def test_eval_cli_int8_on_cpu(tmp_path, capsys):
    """The eval CLI on a synthetic split (resnet18, 64x64 tiles, --device
    cpu): calibrated int8 fast path on all stages, the dynamic int8 fast
    path and Int8Model each print a JSON line; --int8-stages without
    --fastpath 1 --int8 1 exits before any work."""
    from uemda_tpu_torch.datasets.meta import IsprsDA
    from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset
    from uemda_tpu_torch.models.port import save_npz
    from uemda_tpu_torch.tools import eval as eval_cli

    root = tmp_path / "data"
    make_synthetic_dataset(str(root), IsprsDA, n_train=1, n_val=2, hw=64, seed=3)
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from uemda_tpu_torch.config import PRESETS, SplitConfig\n"
        "_v = SplitConfig(({img!r},), ({ann!r},), (120.0, 82.0, 81.0), "
        "(55.0, 39.0, 38.0), batch_size=2)\n"
        "CONFIG = dataclasses.replace(PRESETS['2vaihingen'], model='resnet18', "
        "val=_v, test=_v, crop=(64, 64))\n".format(
            img=str(root / "img_dir" / "val"), ann=str(root / "ann_dir" / "val")))
    model = eval_cli.build_model(eval_cli.load_config(str(cfg_file)), "cpu")
    ckpt = save_npz(str(tmp_path / "w.npz"), model.state_dict())
    base = ["--config-path", str(cfg_file), "--ckpt-path", ckpt, "--device", "cpu"]
    for extra in (["--fastpath", "1", "--int8", "1", "--calib-batches", "1",
                   "--int8-stages", "1,2,3,4"],
                  ["--fastpath", "1", "--int8", "1"],
                  ["--int8", "1"]):
        eval_cli.main(base + extra)
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert 0.0 <= out["miou"] <= 1.0
    with pytest.raises(SystemExit):
        eval_cli.main(base + ["--int8", "1", "--int8-stages", "3,4"])

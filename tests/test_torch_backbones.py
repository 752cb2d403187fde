"""The port's ResNeXt and v1c backbones, per-stage gradient checkpointing and
``--pretrained`` on the CPU against the JAX package, f32: ResNeXt-50 32x4d
and ResNet-50 v1c trunks in eval and train mode and on the fast path,
``state_dict_from_jax`` for grouped convs and deep stems, the freeze mask of
the deep stem, ``with_cp`` (gradients and BatchNorm buffers), and
``build_model(pretrained=...)`` against ``init_variables(pretrained=...)``."""

import copy
import dataclasses
import functools

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import (
    models_from_port,
    no_tf32,
    one_cpu_thread,  # noqa: F401 (fixture)
    to_nhwc,
    to_torch,
)
from uemda_tpu.infer.fastpath import make_serving_fn as jax_make_serving_fn
from uemda_tpu.models import DeeplabV2 as JaxDeeplabV2
from uemda_tpu.models import DeeplabV2Config as JaxConfig
from uemda_tpu.models.port_torch import export_deeplabv2, port_deeplabv2
from uemda_tpu_torch.infer.fastpath import make_serving_fn
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.models import heads as torch_heads
from uemda_tpu_torch.models.port import state_dict_from_jax
from uemda_tpu_torch.train.steps import cast_params, forward_train

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

C, HW = 6, 64
BACKBONES = ("resnext50_32x4d", "resnet50_v1c")


@functools.lru_cache(maxsize=None)
def _pair(resnet_type):
    """(JAX model, variables, port model) carrying the same seeded weights
    (``torch_port_helpers.models_from_port``)."""
    return models_from_port(resnet_type, seed=0, num_classes=C)


def _input(seed=7, b=2):
    return np.random.default_rng(seed).normal(size=(b, HW, HW, 3)).astype(
        np.float32)


def _no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(torch_heads.Dropout, "forward",
                        lambda self, x, generator=None, mask=None: x)


@pytest.mark.parametrize("resnet_type", BACKBONES)
def test_state_dict_from_jax_for_grouped_and_deep_stems(resnet_type):
    """Key for key and value for value, the port's converter equals the JAX
    package's exporter for grouped 3x3s and the v1c stem
    (``stem.{0,1,3,4,6,7}``), and its keys are the port model's; the deep
    stem's freeze mask (``freeze_at`` 1) freezes the same 9 tensors as
    JAX's (``stem_conv1..3``, ``stem_bn1..3``)."""
    from uemda_tpu.train.optim import freeze_mask as jax_freeze_mask
    from uemda_tpu_torch.train.optim import freeze_mask

    _, v, tmodel = _pair(resnet_type)
    deep = resnet_type.endswith("v1c")
    got = state_dict_from_jax(v, deep_stem=deep)
    want = export_deeplabv2(v, deep_stem=deep)
    assert sorted(got) == sorted(want) == sorted(tmodel.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if deep:
        assert "encoder.resnet.stem.6.weight" in got
    else:
        assert tuple(got["encoder.resnet.layer1.0.conv2.weight"].shape) == \
            (128, 4, 3, 3)
    mask = freeze_mask(list(tmodel.named_parameters()), 1)
    frozen = sorted(k for k, t in mask.items() if not t)
    jmask = jax.tree_util.tree_leaves_with_path(
        jax_freeze_mask(v["params"], 1))
    n_jax = sum(1 for _, t in jmask if not t)
    assert len(frozen) == n_jax == (9 if deep else 3)


@pytest.mark.parametrize("resnet_type", BACKBONES)
def test_trunk_matches_jax_in_eval_and_train_mode(resnet_type, monkeypatch):
    """The eval forward (averaged head softmax) against
    ``apply(train=False)``: rtol 1e-3, atol 2e-4 as
    ``test_torch_model.py``. The train forward (dropout off on both sides)
    against ``apply(train=True)``: the stride-16 logits of both heads and
    the instance-normed feature within 2e-3 of their largest entry, and the
    new BatchNorm running statistics within 1e-3 of each tensor's largest
    entry (batch statistics of 2 x 4 x 4 pixels at layer4 and in the heads
    are ill-conditioned in f32; the stage-step tests allow 1e-2)."""
    no_tf32()
    _no_dropout(monkeypatch)
    jmodel, v, tmodel = _pair(resnet_type)
    x = _input()
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    tmodel.eval()
    with torch.no_grad():
        got = to_nhwc(tmodel(to_torch(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-4)

    (j1, j2, jf), mut = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tmodel.train()
    before = {k: b.clone() for k, b in tmodel.named_buffers()}
    try:
        with torch.no_grad():
            t1, t2, tf = forward_train(tmodel, None, to_torch(x), {})
        after = dict(tmodel.named_buffers())
        for a, b in ((t1, j1), (t2, j2), (tf, jf)):
            b = np.asarray(b)
            np.testing.assert_allclose(to_nhwc(a), b, rtol=0,
                                       atol=2e-3 * np.abs(b).max())
        want = state_dict_from_jax({"params": v["params"],
                                    "batch_stats": mut["batch_stats"]},
                                   deep_stem=resnet_type.endswith("v1c"))
        for k, t in after.items():
            if "running" in k:
                w = want[k].numpy()
                np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                           atol=1e-3 * np.abs(w).max(),
                                           err_msg=k)
        assert not torch.equal(after["encoder.resnet.layer4.0.bn2.running_var"],
                               before["encoder.resnet.layer4.0.bn2.running_var"])
    finally:
        tmodel.load_state_dict(before, strict=False)
        tmodel.eval()


@pytest.mark.parametrize("resnet_type", BACKBONES)
def test_fastpath_matches_jax_fastpath(resnet_type, monkeypatch):
    """The port's fast path with ``fused_stages`` (1, 2, 3, 4) against the
    JAX ``make_serving_fn`` (unfused: the fused blocks are exact math, and
    K4's plain version is held to the Pallas kernel in
    ``test_torch_resblock.py``), f32: atol 5e-5, rtol 1e-4 as
    ``test_infer_fastpath.py:47``. As in JAX, the v1c stem runs as library
    convs (no K2 call) and ResNeXt's grouped blocks never reach K4;
    ResNet-50 v1c's identity blocks do (12 calls)."""
    import uemda_tpu_torch.infer.fastpath as fp

    no_tf32()
    jmodel, v, tmodel = _pair(resnet_type)
    x = _input(8)
    jfn, jparams = jax_make_serving_fn(jmodel, v, dtype=jnp.float32)
    want = np.asarray(jax.jit(jfn)(jparams, jnp.asarray(x)))
    calls = {"stem_pool": 0, "bottleneck_identity": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fp, "stem_pool", spy("stem_pool", fp.stem_pool))
    monkeypatch.setattr(fp, "bottleneck_identity",
                        spy("bottleneck_identity", fp.bottleneck_identity))
    fn, params = make_serving_fn(tmodel, dtype=torch.float32,
                                 fused_stages=(1, 2, 3, 4))
    with torch.no_grad():
        got = to_nhwc(fn(params, to_torch(x)))
    assert got.shape == want.shape == (2, HW, HW, C)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    deep = resnet_type.endswith("v1c")
    assert calls == {"stem_pool": 0 if deep else 1,
                     "bottleneck_identity": 12 if deep else 0}


def _cp_config(base, stages):
    return dataclasses.replace(base, backbone=dataclasses.replace(
        base.backbone, with_cp=stages))


def test_with_cp_equals_no_checkpointing_and_jax(monkeypatch):
    """A resnet18 dual-head train forward and backward with ``with_cp`` on
    all four stages against the same model without it, in f32 (the
    masters) and through the bf16 compute copy of the train step
    (``torch.func.functional_call``): gradients and BatchNorm buffers equal
    exactly, so the buffers moved once (the recompute leaves them alone)
    -- and they did move. In f32 the checkpointed trunk's gradients also
    match JAX's ``nn.remat`` stages (``jax.grad`` of the same sum) within
    1e-3 in relative norm (the heads' batch statistics over 2 x 1 x 1
    pooled pixels leave their gradients at rounding noise)."""
    no_tf32()
    _no_dropout(monkeypatch)
    base = DeeplabV2Config.uemda_default(C, resnet_type="resnet18")
    jcfg = JaxConfig.uemda_default(num_classes=C, resnet_type="resnet18")
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, with_cp=(True,) * 4))
    x = _input(9)[:, :32, :32]
    seeded = DeeplabV2(base, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    sd = seeded.state_dict()
    jv = port_deeplabv2({k: t.numpy() for k, t in sd.items()})
    jmodel = JaxDeeplabV2(jcfg)

    def jloss(params):
        (a, b, f), _ = jmodel.apply(
            {"params": params, "batch_stats": jv["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return a.sum() + (b * b).sum() + f.sum()

    jgrad = state_dict_from_jax({"params": jax.jit(jax.grad(jloss))(
        jv["params"]), "batch_stats": jv["batch_stats"]})
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for stages in ((False,) * 4, (True,) * 4):
            model = DeeplabV2(_cp_config(base, stages), device="cpu")
            model.load_state_dict(sd)
            model.train()
            t1, t2, tf = forward_train(model, cast_params(model, dtype),
                                       to_torch(x), {})
            (t1.sum() + (t2 * t2).sum() + tf.sum()).backward()
            runs.append(({n: p.grad for n, p in model.named_parameters()},
                         dict(model.named_buffers())))
        (g0, b0), (g1, b1) = runs
        for k in g0:
            assert torch.equal(g0[k], g1[k]), (dtype, k)
        for k in b0:
            assert torch.equal(b0[k], b1[k]), (dtype, k)
        k = "encoder.resnet.layer3.1.bn1.running_mean"
        assert not torch.equal(b1[k], sd[k])
        if dtype == torch.float32:
            trunk = [k for k in g1 if k.startswith("encoder.resnet.")]
            num = sum(float(((g1[k] - jgrad[k]) ** 2).sum()) for k in trunk)
            den = sum(float((jgrad[k] ** 2).sum()) for k in trunk)
            assert np.sqrt(num / den) < 1e-3, np.sqrt(num / den)


def _torchvision_pth(path, resnet_type, seed):
    """A random torchvision-keyed ImageNet checkpoint of ``resnet_type``:
    the trunk's keys (no ``encoder.resnet.`` prefix, ``num_batches_tracked``
    included) with random values, and an ``fc`` classifier."""
    from uemda_tpu_torch.models.config import BackboneConfig
    from uemda_tpu_torch.models.resnet import RESNET_SPECS, ResNet

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in ResNet(BackboneConfig(resnet_type=resnet_type)).state_dict(
            ).items():
        if t.is_floating_point():
            t = torch.rand(t.shape, generator=g) + (0.5 if "var" in k else 0)
        sd[k] = t
    feat = 512 * RESNET_SPECS[resnet_type][0].expansion
    sd["fc.weight"] = torch.randn(1000, feat, generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, str(path))
    return sd


def test_pretrained_loads_as_jax_init_variables(tmp_path):
    """``build_model(cfg, pretrained=<.pth>)`` for resnet18: the trunk
    equals the JAX package's ``init_variables`` of ``build_model(cfg,
    pretrained=...)`` on the same file, exactly; ``fc.*`` is ignored and
    the heads keep the init the same generator gives without the file. A
    ``.msgpack`` is refused naming ``tools/port_weights.py --kind export``;
    a missing trunk key, a shape mismatch and blocks the model lacks
    raise."""
    from uemda_tpu import config as jax_config
    from uemda_tpu.train.loop import build_model as jax_build_model
    from uemda_tpu.train.loop import init_variables
    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.train.loop import build_model

    pth = tmp_path / "imagenet.pth"
    sd = _torchvision_pth(pth, "resnet18", 4)
    jcfg = dataclasses.replace(jax_config.PRESETS["2vaihingen"],
                               model="resnet18", crop=(32, 32))
    jm = jax_build_model(jcfg, pretrained=str(pth))
    want = state_dict_from_jax(jax.tree.map(
        np.asarray, init_variables(jm, jcfg, seed=0)))
    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18")
    got = build_model(cfg, device="cpu", pretrained=str(pth),
                      generator=torch.Generator().manual_seed(5)).state_dict()
    fresh = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(5)).state_dict()
    n = 0
    for k, t in got.items():
        if k.startswith("encoder.resnet.") and "num_batches" not in k:
            assert torch.equal(t, want[k]), k
            assert torch.equal(t, sd[k[len("encoder.resnet."):]]), k
            n += 1
        else:
            assert torch.equal(t, fresh[k]), k
    assert n == sum(1 for k in sd if "num_batches" not in k
                    and not k.startswith("fc."))
    with pytest.raises(ValueError, match="port_weights.py --kind export"):
        build_model(cfg, device="cpu", pretrained=str(tmp_path / "w.msgpack"))
    for name, edit, err in (
            ("missing", lambda d: d.pop("layer1.0.conv1.weight"), KeyError),
            ("shape", lambda d: d.update({"layer2.0.bn1.weight":
                                          torch.zeros(3)}), ValueError),
            ("deeper", lambda d: d.update({"layer3.9.conv1.weight":
                                           torch.zeros(1)}), KeyError)):
        bad = dict(sd)
        edit(bad)
        torch.save(bad, str(tmp_path / f"{name}.pth"))
        key = {"missing": "layer1.0.conv1.weight", "shape":
               "layer2.0.bn1.weight", "deeper": "layer3.9.conv1.weight"}[name]
        with pytest.raises(err, match=key):
            build_model(cfg, device="cpu",
                        pretrained=str(tmp_path / f"{name}.pth"))


def test_pretrained_v1c_stem_loads_as_jax_port(tmp_path):
    """A ResNet-50 v1c ImageNet ``.pth`` (``stem.{0,1,3,4,6,7}``) loads into
    the port's trunk exactly as the JAX package's
    ``port_imagenet_backbone(deep_stem=True)`` merges it into the same
    variables, and the heads keep their weights."""
    from uemda_tpu.models.port_torch import port_imagenet_backbone
    from uemda_tpu_torch.models.port import load_pretrained_backbone

    _, v, tmodel = _pair("resnet50_v1c")
    pth = tmp_path / "v1c.pth"
    sd = _torchvision_pth(pth, "resnet50_v1c", 6)
    merged = port_imagenet_backbone({k: t.numpy() for k, t in sd.items()},
                                    jax.tree.map(np.array, v), deep_stem=True)
    want = state_dict_from_jax(merged, deep_stem=True)
    model = copy.deepcopy(tmodel)
    load_pretrained_backbone(model, str(pth))
    for k, t in model.state_dict().items():
        if "num_batches" in k:
            continue
        assert torch.equal(t, want[k]), k
    assert torch.equal(model.state_dict()["encoder.resnet.stem.3.weight"],
                       sd["stem.3.weight"])

"""Shared helpers of the PyTorch-port parity tests: layout conversion between
JAX's NHWC and the port's NCHW/channels_last, and one set of seeded flax
weights handed to both packages."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax

from uemda_tpu.models import DeeplabV2 as JaxDeeplabV2
from uemda_tpu.models import DeeplabV2Config as JaxConfig
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.models.port import state_dict_from_jax


@pytest.fixture
def one_cpu_thread(monkeypatch):
    """PyTorch's CPU ops on one thread for the test, and through
    ``OMP_NUM_THREADS`` in the subprocesses it starts. The suite runs six
    workers on the same cores, where each worker's OpenMP team of every
    core spins against the others': four resnet18 stage-2 steps at 64^2
    take 2.4 s alone on an 8-core CPU and 189 s six at a time, 6.4 s on
    one thread either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


def to_torch(x_nhwc: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x_nhwc, np.float32)).permute(
        0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def numpy_tree(variables):
    return jax.tree.map(np.asarray, variables)


def _randomize_bn(tree, rng):
    """Give every BatchNorm non-identity statistics and affine parameters,
    so BN folding is exercised (flax init leaves mean 0, var 1, scale 1,
    bias 0). Mild values keep a deep random ResNet's activations finite."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"bn"} and set(tree["bn"]) <= {"scale", "bias", "mean",
                                                    "var"}:
        bn = tree["bn"]
        n = next(iter(bn.values())).shape
        draw = {"scale": lambda: rng.uniform(0.8, 1.2, n),
                "bias": lambda: rng.normal(0.0, 0.1, n),
                "mean": lambda: rng.normal(0.0, 0.1, n),
                "var": lambda: rng.uniform(0.5, 1.5, n)}
        return {"bn": {k: draw[k]().astype(np.float32) for k in bn}}
    return {k: _randomize_bn(v, rng) for k, v in tree.items()}


def jax_and_torch_models(resnet_type="resnet50", hw=64, seed=0, **overrides):
    """The JAX model with seeded variables (BatchNorm statistics drawn with
    numpy), and the port's model in eval mode on the CPU carrying the same
    weights (f32)."""
    cfg_kw = dict(num_classes=6, resnet_type=resnet_type)
    jcfg = dataclasses.replace(JaxConfig.uemda_default(**cfg_kw), **overrides)
    jmodel = JaxDeeplabV2(jcfg)
    x = np.zeros((1, hw, hw, 3), np.float32)
    variables = numpy_tree(jmodel.init({"params": jax.random.key(seed)}, x,
                                       train=False))
    rng = np.random.default_rng(seed + 100)
    variables = {"params": _randomize_bn(variables["params"], rng),
                 "batch_stats": _randomize_bn(variables["batch_stats"], rng)}
    tcfg = dataclasses.replace(DeeplabV2Config.uemda_default(**cfg_kw),
                               **overrides)
    tmodel = DeeplabV2(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables,
                                               use_ppm=tcfg.use_ppm))
    return jmodel, variables, tmodel


def models_from_port(resnet_type="resnet18", seed=0, num_classes=6):
    """:func:`jax_and_torch_models` without flax's init, which costs seconds
    to a minute a ResNet: a seeded port model's weights through the JAX
    package's converter (``port_deeplabv2``), every BatchNorm's statistics
    and affine drawn with numpy, and back into the port through
    ``state_dict_from_jax``. Returns (JAX model, variables, port model in
    eval mode on the CPU)."""
    from uemda_tpu.models.port_torch import port_deeplabv2

    deep = resnet_type.endswith("v1c")
    cfg = DeeplabV2Config.uemda_default(num_classes, resnet_type=resnet_type)
    seeded = DeeplabV2(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    v = port_deeplabv2({k: t.numpy() for k, t in seeded.state_dict().items()},
                       deep_stem=deep)
    rng = np.random.default_rng(seed + 100)
    v = {"params": _randomize_bn(v["params"], rng),
         "batch_stats": _randomize_bn(v["batch_stats"], rng)}
    jmodel = JaxDeeplabV2(JaxConfig.uemda_default(num_classes=num_classes,
                                                  resnet_type=resnet_type))
    tmodel = copy.deepcopy(seeded)
    tmodel.load_state_dict(state_dict_from_jax(v, deep_stem=deep))
    return jmodel, v, tmodel


def no_tf32():
    """f32 parity: cuDNN would run f32 convs in TF32 by default."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def jax_aug_draws(key, batch, image_hw, crop_hw, mode="oneof"):
    """The draws ``uemda_tpu/datasets/augment.py:34-121`` derives from
    ``key`` for a batch, as the port's ``AugDraws`` (crop origins, then the
    D4 columns of ``mode``)."""
    from uemda_tpu_torch.datasets.augment import AugDraws

    (h, w), (ch, cw) = image_hw, crop_hw
    offsets, d4 = [], []
    for k in jax.random.split(key, batch):
        kc, kd = jax.random.split(k)
        ky, kx = jax.random.split(kc)
        offsets.append([int(jax.random.randint(ky, (), 0, max(h - ch, 0) + 1)),
                        int(jax.random.randint(kx, (), 0, max(w - cw, 0) + 1))])
        if mode == "oneof":
            kc2, kp, kk = jax.random.split(kd, 3)
            d4.append([int(jax.random.uniform(kp) < 0.75),
                       int(jax.random.randint(kc2, (), 0, 3)),
                       int(jax.random.randint(kk, (), 0, 4))])
        else:
            d4.append([int(jax.random.uniform(k_) < 0.5)
                       for k_ in jax.random.split(kd, 3)])
    return AugDraws(torch.tensor(offsets, dtype=torch.int32),
                    torch.tensor(d4, dtype=torch.int64), mode)


def jax_mix_draws(key, mix, hw, class_num, batch=None, ratio=0.5, alpha=1.0):
    """The draws ``uemda_tpu/ops/mixing.py:35-129`` derives from ``key``
    (the mix step's ``k_mix``, ``steps.py:408``), as the port's
    ``MixDraws``: ClassMix's class subset from one permutation; CutMix's
    Beta ``lam`` and box centre from a three-way split; with ``batch``,
    ``cutmix_inbatch``'s permutation and its box from a two-way split."""
    from uemda_tpu_torch.ops.mixing import MixDraws

    if mix in ("classmix", "dacs"):
        perm = np.asarray(jax.random.permutation(key, class_num))
        selected = np.zeros(class_num, np.float32)
        selected[perm[:int(class_num * ratio)]] = 1.0
        return MixDraws(selected=torch.from_numpy(selected))
    perm = None
    if batch is not None:
        k1, key = jax.random.split(key)
        perm = torch.from_numpy(np.asarray(
            jax.random.permutation(k1, batch)).astype(np.int64))
    h, w = hw
    k1, k2, k3 = jax.random.split(key, 3)

    def scalar(x):
        return torch.tensor(np.asarray(x, np.float32))

    return MixDraws(lam=scalar(jax.random.beta(k1, alpha, alpha)),
                    cx=scalar(jax.random.uniform(k2, (), minval=0.0, maxval=w)),
                    cy=scalar(jax.random.uniform(k3, (), minval=0.0, maxval=h)),
                    perm=perm)

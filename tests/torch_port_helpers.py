"""Shared helpers of the PyTorch-port parity tests: layout conversion between
JAX's NHWC and the port's NCHW/channels_last, and one set of seeded flax
weights handed to both packages."""

import dataclasses

import numpy as np
import torch

import jax

from uemda_tpu.models import DeeplabV2 as JaxDeeplabV2
from uemda_tpu.models import DeeplabV2Config as JaxConfig
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.models.port import state_dict_from_jax


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


def no_tf32():
    """f32 parity: cuDNN would run f32 convs in TF32 by default."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

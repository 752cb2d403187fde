"""Import the reference implementation's torch modules from a checkout.

The reference (``uemda``) needs packages that a deployment may lack
(``ever``, ``torch_scatter``, ``ttach``, ``audtorch``, ``skimage``,
``prettytable``, torchvision's transforms). :func:`ref_import` puts the
checkout on ``sys.path`` and installs minimal stand-ins for the surface
the reference touches, written from those packages' documented
semantics, as the repository's test oracle loads it; nothing is
downloaded. ``real_data_gate``'s parity stage builds the reference's
``ResNetEncoder`` and ``Deeplabv2`` with it.
"""

import logging
import os
import sys
import types


class _AttrDict(dict):
    """ever-style config dict: attribute access, recursive update."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = _wrap(v)

    def update(self, other=(), **kw):
        for k, v in dict(other, **kw).items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                self[k].update(v)
            else:
                self[k] = _wrap(v)


def _wrap(v):
    if isinstance(v, dict) and not isinstance(v, _AttrDict):
        return _AttrDict({k: _wrap(x) for k, x in v.items()})
    return v


class _Registry(dict):
    def register(self, name=None, obj=None):
        if obj is not None:
            self[name] = obj
            return obj
        if callable(name):
            self[name.__name__] = name
            return name

        def deco(fn):
            self[fn.__name__ if name is None else name] = fn
            return fn
        return deco


def _module(name, **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def _ever():
    import torch.nn as nn

    class ERModule(nn.Module):
        def __init__(self, config=None):
            super().__init__()
            self.config = _AttrDict()
            self.set_default_config()
            if config is not None:
                self.config.update(config)

        def set_default_config(self):
            raise NotImplementedError

    def freeze_params(module):
        for p in module.parameters():
            p.requires_grad = False

    def freeze_modules(module, cls):
        for m in module.modules():
            if isinstance(m, cls):
                freeze_params(m)

    registry = _module("ever.core.registry", MODEL=_Registry(),
                       DATASET=_Registry())
    logger = _module("ever.core.logger", get_logger=lambda *a, **k:
                     logging.getLogger("reference"))
    param_util = _module("ever.util.param_util", freeze_params=freeze_params,
                         freeze_modules=freeze_modules)
    core = _module("ever.core", registry=registry, logger=logger)
    interface = _module("ever.interface", ERModule=ERModule)
    util = _module("ever.util", param_util=param_util)
    ever = _module("ever", core=core, interface=interface, util=util,
                   ERModule=ERModule)
    return {"ever": ever, "ever.core": core, "ever.core.registry": registry,
            "ever.core.logger": logger, "ever.interface": interface,
            "ever.util": util, "ever.util.param_util": param_util}


def _torch_scatter():
    import torch

    def scatter(src, index, dim=-1, out=None, dim_size=None, reduce="sum"):
        if out is not None:
            raise NotImplementedError("torch_scatter stand-in: out=None only")
        index = index.long().expand_as(src)
        size = list(src.shape)
        size[dim] = int(index.max()) + 1 if dim_size is None else dim_size
        if reduce in ("sum", "add", "mean"):
            o = torch.zeros(size, dtype=src.dtype, device=src.device)
            o.scatter_add_(dim, index, src)
            if reduce != "mean":
                return o
            cnt = torch.zeros_like(o).scatter_add_(dim, index,
                                                   torch.ones_like(src))
            return o / cnt.clamp(min=1)
        if reduce in ("max", "min"):
            fill = float("-inf") if reduce == "max" else float("inf")
            o = torch.full(size, fill, dtype=src.dtype, device=src.device)
            o.scatter_reduce_(dim, index, src, reduce="a" + reduce,
                              include_self=True)
            return torch.where(torch.isinf(o), torch.zeros_like(o), o)
        raise NotImplementedError(reduce)

    return {"torch_scatter": _module("torch_scatter", scatter=scatter)}


def _unavailable(what):
    def fn(*a, **k):
        raise NotImplementedError(f"{what}: not available to the gate")
    return fn


def _ttach():
    return {"ttach": _module("ttach", aliases=types.SimpleNamespace(
        d4_transform=lambda *a, **k: None,
        flip_transform=lambda *a, **k: None))}


def _skimage():
    io = _module("skimage.io", imread=_unavailable("skimage.io.imread"),
                 imsave=_unavailable("skimage.io.imsave"))
    return {"skimage": _module("skimage", io=io), "skimage.io": io}


def _prettytable():
    return {"prettytable": _module(
        "prettytable", PrettyTable=_unavailable("PrettyTable"))}


def _audtorch():
    functional = _module("audtorch.metrics.functional",
                         pearsonr=_unavailable("audtorch pearsonr"))
    metrics = _module("audtorch.metrics", functional=functional)
    return {"audtorch": _module("audtorch", metrics=metrics),
            "audtorch.metrics": metrics,
            "audtorch.metrics.functional": functional}


def _torchvision():
    functional = _module("torchvision.transforms.functional")
    transforms = _module("torchvision.transforms", functional=functional)
    return {"torchvision": _module("torchvision", transforms=transforms),
            "torchvision.transforms": transforms,
            "torchvision.transforms.functional": functional}


# stand-ins by the package they replace; the last five cover imports at
# the top of reference modules the gate does not run (TTA, image I/O,
# tables, Pearson's r, transforms)
STAND_INS = {"ever": _ever, "torch_scatter": _torch_scatter,
             "ttach": _ttach, "skimage": _skimage,
             "prettytable": _prettytable, "audtorch": _audtorch,
             "torchvision": _torchvision}


def ref_import(name: str, root: str):
    """Module ``name`` of the reference checkout at ``root``. A package of
    :data:`STAND_INS` that is not installed gets its stand-in. Raises
    ``FileNotFoundError`` without the checkout."""
    import importlib
    import importlib.util

    if not root or not os.path.isdir(root):
        raise FileNotFoundError(f"no reference checkout at {root!r}")
    if root not in sys.path:
        sys.path.insert(0, root)
    for top, make in STAND_INS.items():
        if top not in sys.modules and importlib.util.find_spec(top) is None:
            sys.modules.update(make())
    return importlib.import_module(name)

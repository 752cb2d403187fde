"""Rules the port keeps: it imports nothing of JAX or of the JAX package, and
its entry points run on the card unless the caller asks for the CPU; a
kernel wrapper takes its plain version only for a CPU tensor."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from uemda_tpu_torch.infer.evaluate import evaluate_dataset
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.ops.crop import crop_normalize
from uemda_tpu_torch.ops.insnorm import instance_norm, instance_norm_backward
from uemda_tpu_torch.ops.mine import uvem_mine
from uemda_tpu_torch.ops.resblock import bottleneck_identity
from uemda_tpu_torch.ops.segment import segment_gather, segment_max, segment_sum
from uemda_tpu_torch.ops.stem import stem_pool
from uemda_tpu_torch.ops.tail import tail_upsample_softmax_mean
from uemda_tpu_torch.utils.runtime import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "uemda_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "uemda_tpu")


def _modules():
    out = []
    for f in sorted(PKG.rglob("*.py")):
        parts = f.relative_to(ROOT).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def _imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_of_jax(path):
    """No import statement, at any depth, names JAX, flax or the JAX
    package (``uemda_tpu_torch`` is not ``uemda_tpu``)."""
    for name in _imported_names(path):
        assert name.split(".")[0] not in BANNED, f"{path.name} imports {name}"


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter that refuses JAX, flax and ``uemda_tpu`` imports
    every module of the port (and runs a tiny CPU forward); none of them is
    in ``sys.modules`` afterwards."""
    code = f"""
import importlib, sys
BANNED = {BANNED!r}
for name in list(sys.modules):
    if name.split(".")[0] in BANNED:
        del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("the port may not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
for m in {_modules()!r}:
    importlib.import_module(m)
import torch
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
cfg = DeeplabV2Config.uemda_default(6, resnet_type="resnet18")
with torch.no_grad():
    DeeplabV2(cfg, device="cpu")(torch.zeros(1, 3, 32, 32))
left = sorted(n for n in sys.modules if n.split(".")[0] in BANNED)
assert not left, left
print("clean", len({_modules()!r}))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["clean", str(len(_modules()))]


def test_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch):
    """device=None means "cuda": without CUDA the entry points raise
    RuntimeError; device="cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DeeplabV2Config.uemda_default(6, resnet_type="resnet18")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeeplabV2(cfg, device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            evaluate_dataset(None, None, (0, 0, 0), (1, 1, 1), device=device)
    from uemda_tpu_torch.alignment.prototypes import init_aligner
    from uemda_tpu_torch.tools import eval as eval_cli
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
    from uemda_tpu_torch.tools import (
        init_prototypes,
        train_align_uem,
        train_src,
        train_ssl_uem,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.build_model(eval_cli.load_config("2vaihingen"), "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_src.main(["--config-path", "2vaihingen", "--steps", "1"])
    ckpt = ["--ckpt-model", "m.pth", "--ckpt-proto", "p.pth"]
    for cli in (init_prototypes, train_align_uem, train_ssl_uem):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--config-path", "2urban"] + ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_pseudo_labels(None, None, (0, 0, 0), (1, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_aligner(7)
    assert resolve_device("cpu") == torch.device("cpu")
    DeeplabV2(cfg, device="cpu")


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on neither the CPU nor the card (here the meta device) is
    refused by every kernel wrapper, not computed by its plain version."""
    fns = (instance_norm, instance_norm_backward, stem_pool,
           tail_upsample_softmax_mean, crop_normalize, segment_max,
           segment_sum, segment_gather, uvem_mine, bottleneck_identity)
    before = [fn.launches for fn in fns]
    x = torch.empty(1, 32, 4, 4, device="meta").contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        instance_norm(x)
    xs = torch.empty(1, 12, 8, 8, device="meta").contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        stem_pool(xs, torch.empty(4, 4, 12, 64, device="meta"),
                  torch.empty(64, device="meta"))
    xt = torch.empty(1, 12, 4, 4, device="meta").contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tail_upsample_softmax_mean(xt, (8, 8), 2, 6)
    stats = torch.zeros(1, 32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        instance_norm_backward(x, x, stats, stats)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        crop_normalize(torch.empty(1, 8, 8, 3, dtype=torch.uint8, device="meta"),
                       torch.zeros(1, 2, dtype=torch.int32), (4, 4),
                       (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    val = torch.empty(1, 16, 7, device="meta")
    ids = torch.zeros(1, 16, dtype=torch.int32, device="meta")
    for seg in (segment_max, segment_sum):
        with pytest.raises(RuntimeError, match="CUDA or CPU"):
            seg(val, ids, 4)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        segment_gather(torch.empty(1, 4, 7, device="meta"), ids)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        uvem_mine(torch.empty(1, 7, 4, 4, device="meta"))
    wm = torch.empty(16, 32, 1, 1, device="meta")
    w2 = torch.empty(16, 16, 3, 3, device="meta").contiguous(
        memory_format=torch.channels_last)
    bm = torch.empty(16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        bottleneck_identity(x, wm, bm, w2, bm, wm.reshape(32, 16, 1, 1),
                            torch.empty(32, device="meta"))
    assert [fn.launches for fn in fns] == before

"""The model's ``with_aux`` head and the pseudo-label analysis tools on the
CPU against the JAX package: ``with_aux`` for two heads, cascade and one
head (ResNet-18, 64^2, f32; the eval forward's rtol 1e-3 / atol 2e-4, its
probabilities bit-equal to the default forward's), ``analyze_pseudo_labels``,
and the ``refine_quality``, ``vis_corrected_pseudo_labels``,
``vis_pseudo_labels``, ``summarize_run`` and ``ablation_stats`` CLIs
against the JAX tools on a tiny synthetic pair with LSC superpixel maps
from the port's own tool: every float of a JSON report within 1e-3 (one
pixel of two 64^2 tiles is 1.2e-4), PNGs, counts and printed tables
equal.

The JAX variables come from a seeded port model (``models_from_port``'s
route: flax's op-by-op init of a ResNet costs seconds to a minute); the
JAX forwards are jitted (an eager first pass costs more than compiling)."""

import dataclasses
import importlib
import json
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import (  # noqa: F401 (one_cpu_thread)
    _randomize_bn,
    no_tf32,
    one_cpu_thread,
    to_nhwc,
    to_torch,
)
from uemda_tpu.infer.analysis import analyze_pseudo_labels as j_analyze
from uemda_tpu.models import DeeplabV2 as JaxDeeplabV2
from uemda_tpu.models import DeeplabV2Config as JaxConfig
from uemda_tpu.models.port_torch import port_deeplabv2
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset
from uemda_tpu_torch.infer.analysis import analyze_pseudo_labels
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.models.port import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 6  # IsprsDA
pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _models(seed=0, **overrides):
    """A seeded ResNet-18 port model with ``overrides`` of the flagship
    config, its weights as flax variables (BatchNorm statistics and affine
    parameters drawn with numpy) and back into the port: (JAX model,
    variables, port model in eval mode on the CPU)."""
    cfg = dataclasses.replace(
        DeeplabV2Config.uemda_default(C, resnet_type="resnet18"), **overrides)
    seeded = DeeplabV2(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    v = port_deeplabv2({k: t.numpy() for k, t in seeded.state_dict().items()},
                       multi_layer=cfg.multi_layer)
    rng = np.random.default_rng(seed + 100)
    v = {"params": _randomize_bn(v["params"], rng),
         "batch_stats": _randomize_bn(v["batch_stats"], rng)}
    jmodel = JaxDeeplabV2(dataclasses.replace(
        JaxConfig.uemda_default(num_classes=C, resnet_type="resnet18"),
        **overrides))
    seeded.load_state_dict(state_dict_from_jax(v))
    return jmodel, v, seeded


@pytest.mark.parametrize("overrides", [{}, {"cascade": True},
                                       {"multi_layer": False}],
                         ids=["two_heads", "cascade", "one_head"])
def test_with_aux_matches_flax(overrides):
    """``model(x, with_aux=True)`` in eval mode: (probs, x1, x2, feat) --
    the instance-normed feature (``feat2`` in cascade mode; x1 twice with
    one head) -- against flax's ``with_aux`` forward at rtol 1e-3 / atol
    2e-4; probs bit-equal to the default forward; train mode returns its
    usual tuple whatever ``with_aux`` says."""
    no_tf32()
    jmodel, v, tmodel = _models(**overrides)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = [np.asarray(o) for o in jax.jit(lambda v_, x_: jmodel.apply(
        v_, x_, train=False, with_aux=True))(v, jnp.asarray(x))]
    with torch.no_grad():
        got = tmodel(to_torch(x), with_aux=True)
        plain = tmodel(to_torch(x))
    assert len(got) == 4 and torch.equal(got[0], plain)
    assert [tuple(to_nhwc(g).shape) for g in got] == [w.shape for w in want]
    if not overrides.get("multi_layer", True):
        assert got[1] is got[2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_nhwc(g), w, rtol=1e-3, atol=2e-4)
    tmodel.train()
    with torch.no_grad():
        tr = tmodel(to_torch(x), with_aux=True,
                    generator=torch.Generator().manual_seed(0))
    n_train = {(): 3, ("cascade",): 4, ("multi_layer",): 2}[tuple(overrides)]
    assert isinstance(tr, tuple) and len(tr) == n_train
    assert tr[0].shape == (2, C, 4, 4)


# ------------------------------------------------- the tiny synthetic pair


def _soft_labels(label, rng):
    """fp16 (H, W, C) soft labels that agree with ``label`` on most pixels,
    peaked enough to be mined."""
    logits = rng.normal(0.0, 1.0, label.shape + (C,))
    onehot = np.eye(C)[np.clip(label, 0, C - 1)]
    logits += 3.0 * onehot * (rng.random(label.shape) < 0.8)[..., None]
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float16)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two 64^2 target tiles with ground truth, LSC maps from the port's
    ``generate_superpixels`` where ``sup_path_for`` reads them, fp16 soft
    labels from a seed, a config for each package (ResNet-18, batch 2, its
    own run dir), a seeded model as ``.pth`` (port) and ``.msgpack`` (JAX)
    with its classifiers scaled up so that pseudo labels are mined,
    prototypes as ``.npy`` and ``.msgpack``, and the JAX variables."""
    from uemda_tpu.train.checkpoints import save_checkpoint
    from uemda_tpu_torch.datasets.base import SegDataset
    from uemda_tpu_torch.tools import generate_superpixels

    d = tmp_path_factory.mktemp("pair")
    img, ann = make_synthetic_dataset(str(d / "data"), IsprsDA, n_train=2,
                                      n_val=1, hw=64, seed=3, with_sup=False)
    generate_superpixels.process_dir(img, ann + "_sup", iterations=20)
    rng = np.random.default_rng(7)
    pseudo = d / "pseudo_label"
    pseudo.mkdir()
    ds = SegDataset(IsprsDA, img, ann)
    for i in range(len(ds)):
        np.save(pseudo / f"{ds.filename(i)}.npy",
                _soft_labels(ds.item(i)["label"], rng))
    files = {}
    for pkg in ("uemda_tpu_torch", "uemda_tpu"):
        f = d / f"cfg_{pkg}.py"
        f.write_text(
            "import dataclasses\n"
            f"from {pkg}.config import PRESETS, SplitConfig\n"
            f"_t = SplitConfig(({img!r},), ({ann!r},), "
            "(120.0, 82.0, 81.0), (55.0, 39.0, 38.0), batch_size=2)\n"
            "CONFIG = dataclasses.replace(PRESETS['2vaihingen'], "
            "model='resnet18', target=_t, crop=(64, 64), "
            f"snapshot_dir={str(d / ('log_' + pkg))!r})\n")
        files[pkg] = str(f)
    _, v, tmodel = _models(seed=5)
    sd = tmodel.state_dict()
    for k in sd:
        if k.endswith("conv_last.4.weight"):
            sd[k] = sd[k] * 20.0
    tmodel.load_state_dict(sd)
    v = port_deeplabv2({k: t.numpy() for k, t in sd.items()})
    torch.save(sd, d / "model.pth")
    save_checkpoint(str(d / "model.msgpack"), v)
    protos = np.random.default_rng(8).normal(size=(C, 512)).astype(np.float32)
    np.save(d / "protos.npy", protos)
    save_checkpoint(str(d / "protos.msgpack"), protos)
    return types.SimpleNamespace(
        dir=d, img=img, ann=ann, pseudo=str(pseudo), cfg=files["uemda_tpu_torch"],
        jcfg=files["uemda_tpu"], pth=str(d / "model.pth"),
        msgpack=str(d / "model.msgpack"), npy=str(d / "protos.npy"),
        proto_msgpack=str(d / "protos.msgpack"), variables=v)


def _jax_tool(name, monkeypatch, pair):
    """The JAX tool's module, its model init replaced by the pair's
    variables (the same tree ``load_checkpoint`` restores into)."""
    sys.path.insert(0, ROOT)
    tool = importlib.import_module(f"tools.{name}")
    if hasattr(tool, "init_variables"):
        monkeypatch.setattr(tool, "init_variables",
                            lambda model, cfg: pair.variables)
    return tool


def _assert_report_close(got, want, atol=1e-3):
    """Same keys; every number within ``atol``; lists element by element."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_report_close(got[k], want[k], atol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_report_close(g, w, atol)
    else:
        assert abs(got - want) <= atol, (got, want)


def test_analyze_pseudo_labels_matches_jax(pair):
    """Coverage, accuracy and the entropy bins of the pair's soft labels
    against its ground truth: within 1e-3 of JAX's (10 and 4 bins, the
    default cutoffs and others)."""
    for top, low, bins in ((0.8, 0.6, 10), (0.5, 0.3, 4)):
        got = analyze_pseudo_labels(pair.ann, pair.pseudo, IsprsDA, top, low,
                                    bins, device="cpu")
        want = j_analyze(pair.ann, pair.pseudo, IsprsDA, top, low, bins)
        _assert_report_close(got, want)
        assert 0 < got["coverage"] < 1 and sum(got["bin_count"]) > 0


def test_refine_quality_matches_the_jax_tool(pair, monkeypatch, capsys):
    """``refine_quality`` over every mode on the pair: the JSON report
    within 1e-3 of the JAX tool's on the same weights (``.pth`` and
    ``.msgpack``), prototypes, soft labels and LSC maps; pixels mined in
    every mode, and the refined modes moving coverage."""
    from uemda_tpu_torch.tools import refine_quality

    no_tf32()
    args = ["--pseudo-dir", pair.pseudo, "--batch-size", "2"]
    got = refine_quality.main(["--config-path", pair.cfg, "--ckpt-model",
                               pair.pth, "--ckpt-proto", pair.npy,
                               "--device", "cpu"] + args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(got))
    tool = _jax_tool("refine_quality", monkeypatch, pair)
    monkeypatch.setattr(sys, "argv", ["refine_quality.py", "--config-path",
                                      pair.jcfg, "--ckpt-model", pair.msgpack,
                                      "--ckpt-proto", pair.proto_msgpack]
                        + args)
    tool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _assert_report_close(printed, want)
    assert all(printed[m]["coverage"] > 0 for m in ("none", "p", "l", "s",
                                                     "all"))
    assert printed["all"]["coverage"] != printed["none"]["coverage"]


def _corrected_line(log_dir):
    """The count of changed pixels from the newest log of ``log_dir``."""
    for name in sorted(os.listdir(log_dir), key=float_stem, reverse=True):
        if name.endswith(".log"):
            with open(os.path.join(log_dir, name)) as f:
                lines = [x for x in f if "corrected" in x]
            if lines:
                return lines[-1].split(";")[-1].strip()
    raise AssertionError(f"no closing line in {log_dir}")


def float_stem(name):
    try:
        return float(os.path.splitext(name)[0])
    except ValueError:
        return -1.0


@pytest.mark.parametrize("mode", ["all", "s"])
def test_vis_corrected_pseudo_labels_matches_the_jax_tool(pair, monkeypatch,
                                                          tmp_path, mode):
    """``vis_corrected_pseudo_labels --refine-mode all|s`` on the pair
    (both load the same ``.pth``): every raw and corrected PNG equal to
    the JAX tool's, and the same logged count of changed pixels."""
    from uemda_tpu_torch.tools import vis_corrected_pseudo_labels as vis

    from PIL import Image

    no_tf32()
    args = ["--ckpt-path", pair.pth, "--refine-mode", mode]
    changed, total = vis.main(["--config-path", pair.cfg, "--ckpt-proto",
                               pair.npy, "--out-dir", str(tmp_path / "port"),
                               "--device", "cpu"] + args)
    tool = _jax_tool("vis_corrected_pseudo_labels", monkeypatch, pair)
    monkeypatch.setattr(sys, "argv", ["vis_corrected_pseudo_labels.py",
                                      "--config-path", pair.jcfg,
                                      "--ckpt-proto", pair.proto_msgpack,
                                      "--out-dir", str(tmp_path / "jax")]
                        + args)
    tool.main()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        f"tile_00{i}_{k}.png" for i in range(2) for k in ("corrected", "raw")]
    for n in names:
        with Image.open(tmp_path / "port" / n) as a, \
                Image.open(tmp_path / "jax" / n) as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    line = _corrected_line(str(pair.dir / "log_uemda_tpu_torch"))
    assert line == _corrected_line(str(pair.dir / "log_uemda_tpu"))
    assert line.startswith(f"corrected {changed}/{total} px")
    assert total == 2 * 64 * 64 and changed > 0


def test_vis_pseudo_labels_matches_the_jax_tool(pair, monkeypatch, capsys,
                                                tmp_path):
    """``vis_pseudo_labels`` on the pair: the printed report within 1e-3 of
    the JAX tool's; ``--plot`` writes the figure."""
    from uemda_tpu_torch.tools import vis_pseudo_labels

    args = ["--label-dir", pair.ann, "--pseudo-dir", pair.pseudo,
            "--cutoff-top", "0.7"]
    vis_pseudo_labels.main(["--config-path", pair.cfg, "--device", "cpu",
                            "--plot", str(tmp_path / "fig.png")] + args)
    out = capsys.readouterr().out
    got = json.loads(out[:out.rindex("}") + 1])
    assert out.rstrip().endswith("fig.png") and (tmp_path / "fig.png").exists()
    tool = _jax_tool("vis_pseudo_labels", monkeypatch, pair)
    monkeypatch.setattr(sys, "argv", ["vis_pseudo_labels.py", "--config-path",
                                      pair.jcfg] + args)
    tool.main()
    _assert_report_close(got, json.loads(capsys.readouterr().out))


# --------------------------------------------------- the run-dir summaries


@dataclasses.dataclass
class _ToyState:
    step: int
    model: torch.nn.Module

    def state_dict(self):
        return {"step": self.step}


def _toy_run(run_dir, steps, eval_every, seed):
    """A run dir as the port's training loop writes it: ``metrics.jsonl``
    and ``best.json`` of a toy step through ``run_training_loop``."""
    from uemda_tpu_torch.train.loop import run_training_loop

    state = _ToyState(0, torch.nn.Linear(1, 1))

    def step(s, bs, bt, _seed):
        s.step += 1
        return {"loss": torch.tensor(1.0 / s.step)}

    def batches():
        while True:
            yield {"x": np.zeros(1, np.float32)}

    os.makedirs(run_dir, exist_ok=True)
    log = logging.getLogger(f"toy.{run_dir}")
    log.propagate = False
    run_training_loop(state, step, batches(), batches(), steps, log,
                      eval_every=eval_every, log_every=eval_every,
                      eval_fn=lambda s: ((s.step * seed) % 97) / 97.0,
                      state_path=os.path.join(run_dir, "state_curr.pth"))


def _capture(fn, capsys):
    fn()
    return capsys.readouterr().out


def test_summarize_run_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    """Two stage dirs the port's loop wrote (evaluations at different
    steps) and a missing one: the same markdown table and summary lines."""
    from uemda_tpu_torch.tools import summarize_run

    _toy_run(str(tmp_path / "src"), 6, 2, 11)
    _toy_run(str(tmp_path / "ssl"), 6, 3, 13)
    (tmp_path / "none").mkdir()
    argv = [f"src={tmp_path / 'src'}", f"ssl={tmp_path / 'ssl'}",
            str(tmp_path / "none")]
    got = _capture(lambda: summarize_run.main(argv), capsys)
    sys.path.insert(0, ROOT)
    jtool = importlib.import_module("tools.summarize_run")
    monkeypatch.setattr(sys, "argv", ["summarize_run.py"] + argv)
    assert got == _capture(jtool.main, capsys)
    assert "| iter | src | ssl | none |" in got and "best mIoU" in got
    assert "no eval rows found" in got


@pytest.mark.parametrize("metric", ["best", "final"])
def test_ablation_stats_matches_the_jax_tool(tmp_path, monkeypatch, capsys,
                                             metric):
    """Seeded variants as the port's loop writes them (two seeds; one run
    missing, one without an evaluation): the same tables and warnings."""
    from uemda_tpu_torch.tools import ablation_stats

    for seed, s in (("2333", 11), ("4001", 29)):
        _toy_run(str(tmp_path / f"s{seed}_uvem_refine" / "ssl"), 4, 2, s)
        _toy_run(str(tmp_path / f"s{seed}_ce" / "ssl"), 4, 2, s + 3)
    _toy_run(str(tmp_path / "s2333_cutmix" / "cutmix"), 4, 2, 5)
    os.makedirs(tmp_path / "s4001_cutmix" / "cutmix")
    argv = ["--root", str(tmp_path), "--seeds", "2333,4001", "--metric", metric]
    got = _capture(lambda: ablation_stats.main(argv), capsys)
    sys.path.insert(0, ROOT)
    jtool = importlib.import_module("tools.ablation_stats")
    monkeypatch.setattr(sys, "argv", ["ablation_stats.py"] + argv)
    assert got == _capture(jtool.main, capsys)
    assert "| uvem_refine |" in got and "mean Δ" in got
    assert "WARNING: s4001_cutmix has no eval rows yet" in got


@pytest.mark.parametrize("mode", ["s", "all"])
def test_ids_at_or_above_max_segments_void_the_tile_as_in_jax(mode):
    """``label_refine``'s 's' view with ``max_segments`` under some of an
    LSC map's ids (128^2 tile, 49 ids, boundary id 64, ``max_segments``
    40), as ``vis_corrected_pseudo_labels`` calls it on 1024^2 tiles (its
    default 2048, LSC's ids up to ~2850, the boundary 4096): the pixels of
    those ids are NaN in both packages, and ``pseudo_selection`` then mines
    no pixel of the tile at all (a NaN class maximum makes every threshold
    NaN), in both. The port keeps the reference's semantics (ROADMAP.md
    C). JAX runs eagerly here: jitted on the CPU, its out-of-range pixels
    vary from compile to compile (1148, 761 or 0 NaN pixels)."""
    from uemda_tpu.alignment.prototypes import init_aligner as j_init
    from uemda_tpu.alignment.prototypes import label_refine as j_refine
    from uemda_tpu.ops.pseudo import pseudo_selection as j_select
    from uemda_tpu_torch.alignment.prototypes import (
        init_aligner,
        label_refine,
    )
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.ops.pseudo import pseudo_selection
    from uemda_tpu_torch.superpixels import superpixels_with_shrink

    img = synthetic_split(LoveDA, n=1, hw=128, seed=4,
                          domain_shift=20.0).images[0]
    n, _, sup = superpixels_with_shrink(img)
    assert (n, sup.max()) == (49, 64)
    rng = np.random.default_rng(0)
    k = 7
    soft = rng.dirichlet(np.ones(k) * 0.3, size=(1, 128, 128)).astype(
        np.float32)
    feat = rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
    pred = rng.normal(size=(1, 8, 8, k)).astype(np.float32)
    protos = rng.normal(size=(k, 16)).astype(np.float32)
    want = np.asarray(j_refine(
        j_init(k, 16, prototypes=jnp.asarray(protos)), jnp.asarray(soft),
        jnp.asarray(feat), [jnp.asarray(pred)], sup=jnp.asarray(sup[None]),
        mode=mode, max_segments=40))
    got = label_refine(
        init_aligner(k, 16, prototypes=torch.from_numpy(protos),
                     device="cpu"),
        to_torch(soft), to_torch(feat), [to_torch(pred)],
        sup=torch.from_numpy(sup[None]), mode=mode, max_segments=40)
    nan = np.isnan(want).any(-1)
    assert nan.sum() == ((sup >= 40) & (sup != 64)).sum() > 0
    np.testing.assert_array_equal(np.isnan(to_nhwc(got)), np.isnan(want))
    np.testing.assert_allclose(to_nhwc(got)[~nan], want[~nan], atol=1e-5)
    hard = pseudo_selection(got, 0.8, 0.6, -1).numpy()
    np.testing.assert_array_equal(hard, np.asarray(j_select(
        jnp.asarray(want), 0.8, 0.6, -1)))
    assert (hard == -1).all()
    # at a bound over every id, the same tile mines pixels
    ok = label_refine(
        init_aligner(k, 16, prototypes=torch.from_numpy(protos),
                     device="cpu"),
        to_torch(soft), to_torch(feat), [to_torch(pred)],
        sup=torch.from_numpy(sup[None]), mode=mode, max_segments=65)
    assert (pseudo_selection(ok, 0.8, 0.6, -1) != -1).any()

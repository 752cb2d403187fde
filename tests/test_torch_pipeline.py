"""The stage-3 and pipeline CLIs of the port on the CPU: the ``run_pipeline``
twin runs the five steps (``train_src``, ``init_prototypes``,
``train_align_uem``, ``init_prototypes``, ``train_ssl_uem`` with its
pseudo-label sweep) on synthetic PNGs, and the PROCA chain (``--method
proca``); every trainer takes the zoo's flags; what is not ported is
refused; the stage-3 hyperparameters match the JAX package's."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from uemda_tpu_torch.config import PRESETS
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.train.steps import StageHParams, make_ssl_step

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

C = 6


def _tiny_config(tmp_path):
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), IsprsDA, n_train=4, n_val=1, hw=80, seed=3)
    img, ann = root / "img_dir", root / "ann_dir"
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from uemda_tpu_torch.config import PRESETS, SplitConfig\n"
        "m, s = (120.0, 82.0, 81.0), (55.0, 39.0, 38.0)\n"
        f"tr = SplitConfig(({str(img / 'train')!r},), ({str(ann / 'train')!r},), m, s, batch_size=2)\n"
        f"va = SplitConfig(({str(img / 'val')!r},), ({str(ann / 'val')!r},), m, s, batch_size=1)\n"
        "CONFIG = dataclasses.replace(PRESETS['2vaihingen'], model='resnet18', "
        f"crop=(64, 64), source=tr, target=tr, val=va, test=va, "
        f"snapshot_dir={str(tmp_path / 'log')!r})\n")
    return str(cfg_file)


def test_pipeline_twin_runs_the_five_steps_on_the_cpu(tmp_path):
    """``run_pipeline --device cpu --stage-steps 1`` on a tiny synthetic
    IsprsDA config (resnet18, 64^2 crops of 80^2 tiles): five subprocesses
    of the port's tools -- train_src, init_prototypes, train_align_uem,
    init_prototypes, train_ssl_uem with the pseudo-label sweep -- leave
    every stage's best model, prototypes and ``best.json``, the
    ``.npy`` soft labels and their colour PNGs; ``--dry-run`` prints the
    same five commands."""
    cfg_file = _tiny_config(tmp_path)
    cmd = [sys.executable, "-m", "uemda_tpu_torch.tools.run_pipeline",
           "--config-path", cfg_file, "--stage-steps", "1", "--device", "cpu"]
    dry = subprocess.run(cmd + ["--dry-run"], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    tools = [line.split()[3] for line in dry.splitlines()
             if line.startswith("+")]
    assert [t.rsplit(".", 1)[1] for t in tools] == [
        "train_src", "init_prototypes", "train_align_uem", "init_prototypes",
        "train_ssl_uem"]
    assert not (tmp_path / "log").exists()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    log = tmp_path / "log"
    for stage in ("src", "align", "ssl"):
        assert (log / stage / "Vaihingen_best.pth").exists(), stage
        best = json.loads((log / stage / "best.json").read_text())
        assert best["step"] == 1 and 0.0 <= best["miou"] <= 1.0
    for stage in ("src", "align"):
        p = torch.load(log / stage / "prototypes_init.pth", weights_only=True)
        assert p.shape == (C, 512) and torch.isfinite(p).all()
    probs = sorted((log / "pseudo_label").glob("*.npy"))
    assert [p.name for p in probs] == [f"tile_{i:03d}.png.npy"
                                       for i in range(4)]
    arr = np.load(probs[0])
    assert arr.dtype == np.float16 and arr.shape == (80, 80, C)
    np.testing.assert_allclose(arr.astype(np.float32).sum(-1), 1.0, atol=1e-2)
    assert len(list((log / "pseudo_label_color").glob("*.png"))) == 4
    shutil.rmtree(log)  # ~2 GB of checkpoints


def test_stage3_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """Nothing is refused any more (the name is kept from then): the
    stage-3 CLI hands ``--num-devices 2`` to the launcher's 2 processes,
    and the pipeline forwards it to its three training steps, as the JAX
    tool (``tools/run_pipeline.py:82``). The pipeline forwards ``--resume auto`` to its three
    training steps and ``--pretrained`` to stage 1; ``--method proca``
    runs stage 1 without CORAL, ``train_align`` for step 3 and plain
    self-training (``--refine-label 0 --lt ce``) for step 5. The stage-3
    step takes every loss of the zoo and refuses an unknown one. (Every
    trainer's zoo flags: ``test_every_trainer_takes_the_zoo_flags``.)"""
    from uemda_tpu_torch.tools import run_pipeline, train_ssl_uem

    monkeypatch.chdir(tmp_path)
    common = ["--config-path", "2vaihingen", "--ckpt-model", "m.pth",
              "--ckpt-proto", "p.pth", "--device", "cpu"]
    from uemda_tpu_torch.parallel import multihost

    spawned = []
    monkeypatch.setattr(multihost, "_spawn",
                        lambda fn, a, n: spawned.append((fn, n)))
    train_ssl_uem.main(common + ["--num-devices", "2"])
    assert spawned == [(train_ssl_uem._run, 2)]
    run_pipeline.main(["--dry-run", "--num-devices", "2"])
    cmds = [line.split() for line in capsys.readouterr().out.splitlines()
            if line.startswith("+")]
    assert [c[3].rsplit(".", 1)[1] for c in cmds
            if " ".join(c[-2:]) == "--num-devices 2"] == [
        "train_src", "train_align_uem", "train_ssl_uem"]
    run_pipeline.main(["--dry-run", "--resume", "auto"])
    cmds = [line.split() for line in capsys.readouterr().out.splitlines()
            if line.startswith("+")]
    assert [c[3].rsplit(".", 1)[1] for c in cmds
            if c[-2:] == ["--resume", "auto"]] == [
        "train_src", "train_align_uem", "train_ssl_uem"]
    assert len(cmds) == 5
    run_pipeline.main(["--dry-run", "--method", "proca", "--pretrained",
                       "imagenet.pth"])
    cmds = [line.split() for line in capsys.readouterr().out.splitlines()
            if line.startswith("+")]
    assert [c[3].rsplit(".", 1)[1] for c in cmds] == [
        "train_src", "init_prototypes", "train_align", "init_prototypes",
        "train_ssl_uem"]
    src = " ".join(cmds[0])
    assert "--align-domain 0" in src and "--pretrained imagenet.pth" in src
    assert "--refine-label 0 --lt ce" in " ".join(cmds[4])
    assert all("--pretrained" not in c for c in cmds[1:])
    model = DeeplabV2(DeeplabV2Config.uemda_default(C, resnet_type="resnet18"),
                      device="cpu")
    for loss in ("uvem", "ups", "ohem", "focal", "ghm", "gdp", "ce", "none"):
        make_ssl_step(model, StageHParams(class_num=C, target_loss=loss))
    with pytest.raises(ValueError, match="target_loss"):
        make_ssl_step(model, StageHParams(class_num=C, target_loss="dice"))
    assert not any(tmp_path.iterdir())


def test_every_trainer_takes_the_zoo_flags(tmp_path, monkeypatch):
    """Each trainer CLI on the tiny config hands its loop (stubbed here) a
    step and state built from the flags it used to refuse: ``--ls
    OhemCrossEntropy``, every ``--lt`` of its zoo, ``--accum-steps 2`` (the
    schedule's horizon then counts updates) and, for ``train_src``,
    ``--pretrained`` (a torchvision-keyed ``.pth``); ``train_align`` builds
    PROCA's step with its ``--conf-thresh``, and ``train_ssl`` is
    ``train_ssl_uem --lt ce --refine-label 0``."""
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.tools import (
        train_align,
        train_align_uem,
        train_src,
        train_ssl,
        train_ssl_mix,
        train_ssl_uem,
    )
    from uemda_tpu_torch.train.loop import build_model

    monkeypatch.chdir(tmp_path)
    cfg_file = _tiny_config(tmp_path)
    model = build_model(load_config(cfg_file), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "m.pth")
    trunk = {k[len("encoder.resnet."):]: torch.full_like(v, 0.5)
             for k, v in model.state_dict().items()
             if k.startswith("encoder.resnet.")}
    torch.save(trunk, tmp_path / "imagenet.pth")
    np.save(tmp_path / "p.npy", np.zeros((C, 512), np.float32))
    seen = []

    def loop(state, step_fn, *a, **k):
        seen.append((step_fn, state))
        return {"miou": 0.0, "step": 0}

    for mod in (train_src, train_align, train_align_uem, train_ssl_uem,
                train_ssl_mix):
        monkeypatch.setattr(mod, "run_training_loop", loop)
    for mod in (train_ssl_uem, train_ssl_mix):
        monkeypatch.setattr(mod, "generate_pseudo_labels", lambda *a, **k: None)
    ckpts = ["--ckpt-model", str(tmp_path / "m.pth"), "--ckpt-proto",
             str(tmp_path / "p.npy")]
    base = ["--config-path", cfg_file, "--device", "cpu", "--steps", "4",
            "--ls", "OhemCrossEntropy", "--accum-steps", "2"]
    runs = [(train_src.main, ["--pretrained", str(tmp_path / "imagenet.pth")],
             "SrcStep", None),
            (train_align_uem.main, ckpts, "AlignStep", None),
            (train_align.main, ckpts + ["--conf-thresh", "0.5"],
             "AlignSimpleStep", None)]
    runs += [(train_ssl_uem.main, ckpts + ["--lt", lt], "SslStep", lt)
             for lt in ("ups", "ohem", "focal", "ghm", "gdp")]
    runs += [(train_ssl_mix.main, ckpts + ["--lt", lt], "MixStep", lt)
             for lt in ("ups", "ghm", "legacy")]
    runs += [(train_ssl.main, ckpts, "SslStep", "ce")]
    for main, flags, kind, lt in runs:
        main(base + flags)
        step_fn, state = seen.pop()
        assert type(step_fn).__name__ == kind, (main, flags)
        assert step_fn.hp.source_loss == "ohem"
        assert state.opt.accum_steps == 2 and state.ghm is not None
        assert state.opt.schedule(1) == _schedule(cfg_file, 2)(1)
        if lt is not None:
            assert step_fn.hp.target_loss == ("ce" if lt == "legacy" else lt)
        if main is train_ssl.main:
            assert step_fn.hp.refine is False
        if kind == "AlignSimpleStep":
            assert step_fn.conf_thresh == 0.5
        if kind == "SrcStep":
            w = state.model.state_dict()["encoder.resnet.layer1.0.conv1.weight"]
            assert torch.equal(w, torch.full_like(w, 0.5))
    shutil.rmtree(tmp_path / "log")


def _schedule(cfg_file, updates):
    """The poly-warmup schedule over ``updates`` real updates."""
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.train.lr import poly_warmup_schedule

    cfg = load_config(cfg_file)
    return poly_warmup_schedule(cfg.learning_rate, updates, cfg.power)


def test_proca_pipeline_runs_on_the_cpu(tmp_path):
    """``run_pipeline --method proca --device cpu --stage-steps 1 --steps
    1,2,3`` on the tiny config: the chain's PROCA-specific steps as
    subprocesses -- train_src without CORAL, init_prototypes and
    ``train_align`` (PROCA's stage 2) -- each stage leaving its best model
    and ``best.json``. Steps 4 and 5 are the UemDA chain's tools
    (``test_pipeline_twin_runs_the_five_steps_on_the_cpu``) with the flags
    ``test_stage3_refuses_what_is_not_ported`` reads from the dry run."""
    cfg_file = _tiny_config(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "uemda_tpu_torch.tools.run_pipeline",
         "--config-path", cfg_file, "--stage-steps", "1", "--device", "cpu",
         "--method", "proca", "--steps", "1,2,3"], capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    cmds = [line.split() for line in r.stdout.splitlines()
            if line.startswith("+")]
    assert [c[3].rsplit(".", 1)[1] for c in cmds] == [
        "train_src", "init_prototypes", "train_align"]
    assert "--align-domain 0" in " ".join(cmds[0])
    log = tmp_path / "log"
    for stage in ("src", "align"):
        assert (log / stage / "Vaihingen_best.pth").exists(), stage
        best = json.loads((log / stage / "best.json").read_text())
        assert best["step"] == 1 and 0.0 <= best["miou"] <= 1.0
    p = torch.load(log / "align" / "prototypes_best.pth", weights_only=True)
    assert p.shape == (C, 512) and torch.isfinite(p).all()
    shutil.rmtree(log)  # ~1 GB of checkpoints


def test_stage3_hparams_match_jax():
    """``default_hparams`` carries the JAX package's stage-3 fields for
    every preset: the clamp on the ISPRS configs only, UVEM with m 0.2,
    t 0.7, gamma 4 and no class balance by default."""
    from uemda_tpu import config as jax_config
    from uemda_tpu.train.loop import default_hparams as jax_default_hparams
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.train.loop import default_hparams

    fields = ("clamp_target", "target_loss", "balance_target",
              "balance_source", "uvem_m", "uvem_t", "uvem_g")
    for name in jax_config.PRESETS:
        got = default_hparams(load_config(name))
        want = jax_default_hparams(jax_config.load_config(name))
        assert {f: getattr(got, f) for f in fields} == \
            {f: getattr(want, f) for f in fields}, name
    assert default_hparams(PRESETS["2vaihingen"]).clamp_target
    assert not default_hparams(PRESETS["2urban"]).clamp_target

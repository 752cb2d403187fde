"""The stage-3 and pipeline CLIs of the port on the CPU: the ``run_pipeline``
twin runs the five steps (``train_src``, ``init_prototypes``,
``train_align_uem``, ``init_prototypes``, ``train_ssl_uem`` with its
pseudo-label sweep) on synthetic PNGs; what is not ported is refused; the
stage-3 hyperparameters match the JAX package's."""

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
    """The stage-3 CLI refuses accumulation, OHEM, the unported target
    losses and the multi-process flag before it touches a file, naming
    each one's ROADMAP queue item (``--steps-per-call``, ``--host-crop``,
    ``--profile-dir`` and ``--resume`` run: test_torch_loop.py); the
    pipeline refuses --method proca, --pretrained and --num-devices
    (--gate runs: test_torch_serving.py) and forwards ``--resume auto`` to
    its three training steps; the step refuses the unported target
    losses."""
    from uemda_tpu_torch.tools import run_pipeline, train_ssl_uem

    monkeypatch.chdir(tmp_path)
    common = ["--config-path", "2vaihingen", "--ckpt-model", "m.pth",
              "--ckpt-proto", "p.pth", "--device", "cpu"]
    for flags, item in ((["--accum-steps", "2"], "A5"),
                        (["--ls", "OhemCrossEntropy"], "A5"),
                        (["--lt", "ups"], "A5"), (["--lt", "ghm"], "A5"),
                        (["--num-devices", "2"], "A8")):
        with pytest.raises(NotImplementedError, match=f"queue {item}"):
            train_ssl_uem.main(common + flags)
    for flags, item in ((["--method", "proca"], "A6"),
                        (["--pretrained", "x.pth"], "A5"),
                        (["--num-devices", "2"], "A8")):
        with pytest.raises(NotImplementedError, match=f"queue {item}"):
            run_pipeline.main(["--dry-run"] + flags)
    run_pipeline.main(["--dry-run", "--resume", "auto"])
    cmds = [line.split() for line in capsys.readouterr().out.splitlines()
            if line.startswith("+")]
    assert [c[3].rsplit(".", 1)[1] for c in cmds
            if c[-2:] == ["--resume", "auto"]] == [
        "train_src", "train_align_uem", "train_ssl_uem"]
    assert len(cmds) == 5
    model = DeeplabV2(DeeplabV2Config.uemda_default(C, resnet_type="resnet18"),
                      device="cpu")
    for loss in ("ups", "ohem", "focal", "ghm", "gdp"):
        with pytest.raises(NotImplementedError, match="queue A5"):
            make_ssl_step(model, StageHParams(class_num=C, target_loss=loss))
    assert not any(tmp_path.iterdir())


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

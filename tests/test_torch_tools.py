"""The port's analysis and gate tools on the CPU against the JAX tools:
``class_distribution`` (its rates and JSON equal), ``tsne_dataset``'s
``sample_features`` (labels equal, features rtol 1e-4 / atol 1e-4 in f32,
the model's BatchNorm buffers unchanged) and the two t-SNE CLIs' PNGs,
``profile_summary``'s interval union (equal) and its reader of the port's
chrome traces (a hand-made trace with a known answer, a CPU trace a port
trainer wrote), ``hostcrop_ab`` (the JAX tool's keys, finite losses) and
``real_data_gate`` (``check_sum`` on every case of its table, the
deeplabv2 gate's mIoU within 1e-4 of the JAX gate's, ``--kind imagenet
--out``, the parity stage against a stand-in reference checkout, and
against the live reference where ``tests/ref_oracle.py`` finds it).

A tiny LoveDA pair (ResNet-18, 64^2 tiles with 8-pixel padding borders,
7 classes) is made once for the module; its weights come from a seeded
port model (``models_from_port``)."""

import ast
import functools
import hashlib
import importlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (  # noqa: F401 (one_cpu_thread)
    models_from_port,
    one_cpu_thread,
)
from uemda_tpu_torch.datasets.meta import LoveDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 7  # LoveDA
pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _jax_tool(name):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module(f"tools.{name}")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two tiny synthetic LoveDA splits (source: 3 train + 2 val tiles of
    64^2; target shifted), one config file for each package's
    ``load_config`` (resnet18, 64^2 crops), a seeded model as JAX
    variables, the port model and its ``.pth``."""
    d = tmp_path_factory.mktemp("tools")
    for dom, seed, shift in (("src", 0, 0.0), ("tgt", 1, 12.0)):
        make_synthetic_dataset(str(d / dom), LoveDA, n_train=3, n_val=2,
                               hw=64, seed=seed, domain_shift=shift,
                               pad_border=8, with_sup=False)
    files = {}
    for pkg in ("uemda_tpu_torch", "uemda_tpu"):
        f = d / f"cfg_{pkg}.py"
        splits = {k: (d / dom / "img_dir" / sp, d / dom / "ann_dir" / sp)
                  for k, dom, sp in (("s", "src", "train"),
                                     ("t", "tgt", "train"),
                                     ("v", "tgt", "val"))}
        f.write_text(
            "import dataclasses\n"
            f"from {pkg}.config import PRESETS, SplitConfig\n"
            "m, s = (120.0, 82.0, 81.0), (55.0, 39.0, 38.0)\n"
            + "".join(f"_{k} = SplitConfig(({str(i)!r},), ({str(a)!r},), "
                      f"m, s, batch_size=2)\n" for k, (i, a) in splits.items())
            + "CONFIG = dataclasses.replace(PRESETS['2urban'], "
            "model='resnet18', source=_s, target=_t, val=_v, test=_v, "
            f"crop=(64, 64), snapshot_dir={str(d / 'log')!r})\n")
        files[pkg] = str(f)
    jmodel, variables, tmodel = models_from_port("resnet18", seed=2,
                                                 num_classes=C)
    ckpt = str(d / "w.pth")
    torch.save(tmodel.state_dict(), ckpt)
    return types.SimpleNamespace(dir=d, cfg=files["uemda_tpu_torch"],
                                 jcfg=files["uemda_tpu"], jmodel=jmodel,
                                 variables=variables, tmodel=tmodel,
                                 ckpt=ckpt)


def _json_head(text):
    """The indented JSON a tool printed before its last line."""
    return json.loads(text[:text.rindex("}") + 1])


def test_class_rates_and_cli_equal_jax(pair, tmp_path, monkeypatch, capsys):
    """The CLI's JSON (rates rounded to 5, with padding-border ignore
    pixels left out) equals the JAX tool's, both write their charts, and
    ``class_rates`` of an in-memory split equals the JAX function's and a
    numpy recount."""
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.tools import class_distribution

    jtool = _jax_tool("class_distribution")
    monkeypatch.setattr(sys, "argv", ["class_distribution.py",
                                      "--config-path", pair.jcfg, "--out",
                                      str(tmp_path / "jax.png")])
    jtool.main()
    want = _json_head(capsys.readouterr().out)
    class_distribution.main(["--config-path", pair.cfg, "--out",
                             str(tmp_path / "port.png")])
    got = _json_head(capsys.readouterr().out)
    assert got == want and len(got["source"]) == C
    assert (tmp_path / "jax.png").stat().st_size > 0
    assert (tmp_path / "port.png").stat().st_size > 0

    ds = synthetic_split(LoveDA, n=3, hw=64, seed=5)
    ds.labels[0, :4] = -1
    rates = class_distribution.class_rates(ds)
    assert np.array_equal(rates, jtool.class_rates(ds))
    counts = np.array([(ds.labels == c).sum() for c in range(C)], np.float64)
    assert rates.dtype == np.float64
    assert np.array_equal(rates, counts / counts.sum())


def test_sample_features_matches_jax(pair):
    """Train-mode features of the first two source tiles: the picked
    labels equal JAX's, the features within rtol 1e-4 / atol 1e-4, the
    repository's gate for the train-mode forward
    (``test_torch_train_model.py``): flax's BatchNorm takes the batch
    variance as E[x^2] - E[x]^2, which cancels on every one of the
    encoder's batch-statistics layers, and the instance norm then divides
    by each channel's spread over 4 x 4 cells (max abs difference 4.4e-5
    here, 6.4e-5 at 128^2); the model's BatchNorm buffers and its mode are
    as they were."""
    from uemda_tpu.datasets.base import SegDataset as JaxSegDataset
    from uemda_tpu.datasets.meta import LoveDA as JaxLoveDA
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.datasets.base import SegDataset
    from uemda_tpu_torch.tools.tsne_dataset import sample_features

    jtool = _jax_tool("tsne_dataset")
    cfg = load_config(pair.cfg)
    src = cfg.source
    ds = SegDataset(cfg.meta, list(src.image_dir), src.mask_dir[0])
    jds = JaxSegDataset(JaxLoveDA, list(src.image_dir), src.mask_dir[0])
    model = pair.tmodel
    before = {k: v.clone() for k, v in model.state_dict().items()}
    feats, labels = sample_features(model, ds, src.mean, src.std,
                                    max_images=2, samples_per_image=10)
    jfeats, jlabels = jtool.sample_features(pair.jmodel, pair.variables, jds,
                                            src.mean, src.std, max_images=2,
                                            samples_per_image=10)
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert labels.dtype == jlabels.dtype and np.array_equal(labels, jlabels)
    assert feats.shape == jfeats.shape == (len(labels), 512)
    assert 0 < len(labels) <= 20 and (labels >= 0).all()
    np.testing.assert_allclose(feats, jfeats, rtol=1e-4, atol=1e-4)


def test_tsne_clis_write_their_pngs(pair, tmp_path, capsys, monkeypatch):
    """``tsne_dataset`` over both splits and ``tsne_img`` on a 128^2 tile
    (64 feature cells, more than t-SNE's perplexity 30) write their
    figures; without scikit-learn the CLI raises an ImportError naming
    it."""
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.tools import tsne_dataset, tsne_img

    out = tmp_path / "tsne.png"
    tsne_dataset.main(["--config-path", pair.cfg, "--ckpt-path", pair.ckpt,
                       "--max-images", "2", "--perplexity", "5", "--out",
                       str(out), "--device", "cpu"])
    img_dir, _ = make_synthetic_dataset(str(tmp_path / "big"), LoveDA,
                                        n_train=1, n_val=0, hw=128, seed=9,
                                        with_sup=False)
    out_img = tmp_path / "tsne_img.png"
    tsne_img.main(["--config-path", pair.cfg, "--ckpt-path", pair.ckpt,
                   "--image-path", os.path.join(img_dir, "tile_000.png"),
                   "--out", str(out_img), "--device", "cpu"])
    assert capsys.readouterr().out.split() == [str(out), str(out_img)]
    assert out.stat().st_size > 0 and out_img.stat().st_size > 0
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tsne_dataset.main(["--config-path", pair.cfg, "--ckpt-path",
                           pair.ckpt, "--device", "cpu"])


def test_union_busy_matches_jax():
    from uemda_tpu_torch.tools.profile_summary import _union_busy

    jtool = _jax_tool("profile_summary")
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 5, 40, 300):
        s = rng.integers(0, 1000, n)
        iv = [(int(a), int(a + d)) for a, d in zip(s, rng.integers(0, 80, n))]
        assert _union_busy(iv) == jtool._union_busy(iv)


def _event(cat, name, pid, tid, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def test_reader_on_a_hand_made_trace(tmp_path, capsys):
    """Device 0: stream 7 busy 30 us of kernels (two calls of one kernel),
    stream 13 a 10 us copy inside them and a 5 us memset after; the span
    [100, 150) us, the union 35 us (idle 0.3). Device 1: one kernel.
    Host events, flows and metadata are no device work; ``--all-planes``
    adds the host's thread."""
    from uemda_tpu_torch.tools import profile_summary

    events = [
        _event("kernel", "gemm", 0, 7, 100.0, 20.0),
        _event("kernel", "softmax", 0, 7, 125.0, 5.0),
        _event("kernel", "gemm", 0, 7, 140.0, 5.0),
        _event("gpu_memcpy", "Memcpy HtoD", 0, 13, 105.0, 10.0),
        _event("gpu_memset", "Memset", 0, 13, 145.0, 5.0),
        _event("kernel", "gemm", 1, 7, 0.0, 2.5),
        _event("cpu_op", "aten::mm", 4242, 4242, 90.0, 70.0),
        _event("gpu_user_annotation", "step", 0, 7, 100.0, 50.0),
        {"ph": "s", "cat": "ac2g", "id": 1, "pid": 0, "tid": 7, "ts": 100},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    res = profile_summary.main([str(tmp_path), "--top", "2"])[str(path)]
    d0 = res["devices"][0]
    assert d0["span_us"] == 50.0 and d0["busy_us"] == 35.0
    assert d0["line_busy_us"] == {7: 30.0, 13: 15.0}
    assert d0["top"] == [("gemm", 25.0), ("Memcpy HtoD", 10.0)]
    assert d0["calls"]["gemm"] == 2
    assert res["devices"][1]["busy_us"] == 2.5 and res["hosts"] == {}
    out = capsys.readouterr().out
    assert "device busy 0.035 ms (70.0%), idle share 0.300" in out
    assert "stream 7" in out and "x2" in out
    res = profile_summary.main([str(path), "--all-planes"])[str(path)]
    assert res["hosts"][4242]["busy_us"] == 70.0
    assert "host 4242" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no trace"):
        profile_summary.main([str(tmp_path / "none")])


def test_reader_on_a_port_trainers_cpu_trace(pair, tmp_path, capsys,
                                             monkeypatch):
    """``train_src --profile-dir`` on the CPU writes a trace of step 2
    (``trace.json``): the reader finds no device events and says so, and
    with ``--all-planes`` it sums the host's operators."""
    from uemda_tpu_torch.tools import profile_summary, train_src

    monkeypatch.chdir(tmp_path)
    train_src.main(["--config-path", pair.cfg, "--steps", "3", "--device",
                    "cpu", "--profile-dir", str(tmp_path / "prof")])
    capsys.readouterr()
    res = profile_summary.main([str(tmp_path / "prof"), "--all-planes"])
    (trace, got), = res.items()
    assert trace.endswith("trace.json") and got["devices"] == {}
    out = capsys.readouterr().out
    assert "no device events" in out and "host" in out
    (host,) = [h for h in got["hosts"].values()]
    assert host["busy_us"] > 0 and any(n.startswith("aten::")
                                       for n, _ in host["top"])


def _jax_record_keys():
    """The keys of the JSON line ``tools/hostcrop_ab.py`` prints, read from
    its source (running it compiles a JAX step)."""
    with open(os.path.join(ROOT, "tools", "hostcrop_ab.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in tools/hostcrop_ab.py")


def test_hostcrop_ab_on_a_tiny_config(tmp_path, capsys, monkeypatch):
    """The CLI on 96^2 tiles cropped to 64^2 (one pair, one warm-up and one
    timed step an arm): one JSON line with the JAX tool's keys, finite
    losses in both arms, and host-cropped batches of the crop's size in
    the 'on' arm."""
    from uemda_tpu_torch.tools import hostcrop_ab

    make_synthetic_dataset(str(tmp_path / "d"), LoveDA, n_train=4, n_val=1,
                           hw=96, seed=0, pad_border=8, with_sup=False)
    img, ann = tmp_path / "d" / "img_dir", tmp_path / "d" / "ann_dir"
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from uemda_tpu_torch.config import PRESETS, SplitConfig\n"
        "m, s = (120.0, 82.0, 81.0), (55.0, 39.0, 38.0)\n"
        f"tr = SplitConfig(({str(img / 'train')!r},), "
        f"({str(ann / 'train')!r},), m, s, batch_size=2)\n"
        "CONFIG = dataclasses.replace(PRESETS['2urban'], model='resnet18', "
        "source=tr, target=tr, crop=(64, 64))\n")
    seen, results = [], []
    real_measure, real_ab = hostcrop_ab.measure_arm, hostcrop_ab.run_ab

    def measure(model0, cfg, hp, src_iter, tgt_iter, *a, **k):
        first = next(src_iter)
        seen.append(first["image"].shape)

        def again():
            yield first
            yield from src_iter
        return real_measure(model0, cfg, hp, again(), tgt_iter, *a, **k)

    monkeypatch.setattr(hostcrop_ab, "measure_arm", measure)
    monkeypatch.setattr(hostcrop_ab, "run_ab", lambda *a, **k: results.append(
        real_ab(*a, **k)) or results[-1])
    hostcrop_ab.main(["--config-path", str(cfg_file), "--steps", "1",
                      "--warmup", "1", "--pairs", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (record, losses), = results
    assert line == record and set(line) == _jax_record_keys()
    assert line["crop"] == [64, 64] and line["batch"] == 2
    assert line["steps_per_arm"] == 1 and len(line["pairs"]) == 1
    assert seen == [(2, 96, 96, 3), (2, 64, 64, 3)]
    assert all(np.isfinite(ls).all() and len(ls) == 2
               for v in losses.values() for ls in v)


def _sum_args(path, **kw):
    base = dict(torch_ckpt=str(path), expect_sha256="", kind="imagenet",
                resnet_type="resnet50", allow_unverified=False)
    return types.SimpleNamespace(**{**base, **kw})


def test_check_sum_matches_jax_on_every_case(tmp_path, monkeypatch):
    """Pins (full, prefix, upper case, wrong), the ImageNet table (a known
    prefix, a mismatch, an unknown type, ``--allow-unverified``) and a
    trained checkpoint: the same verdict and record as the JAX tool's."""
    from uemda_tpu_torch.tools import real_data_gate as gate

    jtool = _jax_tool("real_data_gate")
    assert gate.KNOWN_SHA8 == jtool.KNOWN_SHA8
    f = tmp_path / "w.pth"
    f.write_bytes(b"not weights, just bytes to hash")
    digest = hashlib.sha256(f.read_bytes()).hexdigest()
    for mod in (gate, jtool):
        monkeypatch.setitem(mod.KNOWN_SHA8, "resnet_test", digest[:8])
    cases = [dict(expect_sha256=digest), dict(expect_sha256=digest[:10]),
             dict(expect_sha256=digest[:10].upper()),
             dict(expect_sha256="0" * 8), dict(resnet_type="resnet_test"),
             dict(), dict(resnet_type="resnet_x"),
             dict(allow_unverified=True), dict(kind="deeplabv2"),
             dict(kind="deeplabv2", expect_sha256="f" * 64)]
    for kw in cases:
        got, want = {}, {}
        assert gate.check_sum(_sum_args(f, **kw), got) == \
            jtool.check_sum(_sum_args(f, **kw), want), kw
        assert got == want, kw


def test_gate_deeplabv2_eval_matches_the_jax_gate(pair, tmp_path, capsys,
                                                  monkeypatch):
    """``--kind deeplabv2 --skip-parity --run-eval`` on a ``.pth`` that the
    JAX package's ``export_deeplabv2`` wrote: the port's strict load and
    f32 evaluation give the JAX gate's mIoU (its evaluation held to f32)
    within 1e-4, and the same JSON keys."""
    import uemda_tpu.infer.evaluate as jax_evaluate
    from uemda_tpu.models.port_torch import export_deeplabv2
    from uemda_tpu_torch.tools import real_data_gate as gate

    sd = {k: torch.as_tensor(np.asarray(v))
          for k, v in export_deeplabv2(pair.variables).items()}
    ckpt = tmp_path / "ref.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               ckpt)
    argv = ["--torch-ckpt", str(ckpt), "--kind", "deeplabv2",
            "--resnet-type", "resnet18", "--skip-parity", "--run-eval"]
    jtool = _jax_tool("real_data_gate")
    monkeypatch.setattr(jax_evaluate, "evaluate_dataset", functools.partial(
        jax_evaluate.evaluate_dataset, compute_dtype="float32"))
    monkeypatch.setattr(sys, "argv", ["real_data_gate.py"] + argv
                        + ["--config-path", pair.jcfg])
    jtool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = gate.main(argv + ["--config-path", pair.cfg, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want) and got["ok"] and want["ok"]
    assert got["parity"] == "skipped" and got["sha_ok"] is None
    np.testing.assert_allclose(got["eval_miou"], want["eval_miou"], atol=1e-4)


def test_gate_imagenet_out_feeds_pretrained(pair, tmp_path, capsys):
    """``--kind imagenet --out``: the written full-model ``.pth`` holds the
    torchvision file's trunk, and ``build_model(pretrained=...)`` (the
    trainers' ``--pretrained``) loads it whole; a wrong pin exits 1 with
    ``"failed": "checksum"``."""
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.tools import real_data_gate as gate
    from uemda_tpu_torch.train.loop import build_model

    trunk = {k: v.clone() for k, v in
             pair.tmodel.encoder.resnet.state_dict().items()}
    trunk["fc.weight"] = torch.zeros(1000, 512)
    src = tmp_path / "resnet18-00000000.pth"
    torch.save(trunk, src)
    out = tmp_path / "ported.pth"
    argv = ["--torch-ckpt", str(src), "--resnet-type", "resnet18",
            "--num-classes", str(C), "--skip-parity", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        gate.main(argv + ["--expect-sha256", "deadbeef"])
    rec = json.loads(capsys.readouterr().out.strip())
    assert e.value.code == 1 and rec["failed"] == "checksum"
    with pytest.raises(SystemExit):   # the table has no such digest
        gate.main(argv)
    assert json.loads(capsys.readouterr().out)["sha_ok"] is False
    rec = gate.main(argv + ["--allow-unverified", "--out", str(out)])
    assert rec["ok"] and rec["ported"] == str(out)
    saved = torch.load(out, weights_only=True)
    for k, v in trunk.items():
        if k != "fc.weight":
            assert torch.equal(saved["encoder.resnet." + k], v), k
    model = build_model(load_config(pair.cfg), "cpu", pretrained=str(out))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def _stand_in_reference(root):
    """A checkout laid out as the reference (``uemda/models/Encoder.py``,
    ``uemda/resnet.py``, ``uemda/_resnets.py``) whose modules are ever
    ``ERModule``s wrapping the port's own; ``Deeplabv2`` doubles its
    output, so its parity fails, unless ``EXACT`` is set."""
    pkg = root / "uemda"
    (pkg / "models").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "models" / "__init__.py").write_text("")
    (pkg / "models" / "Encoder.py").write_text(
        "import os\n"
        "from ever.interface import ERModule\n"
        "from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config\n"
        "class Deeplabv2(ERModule):\n"
        "    def __init__(self, config):\n"
        "        super().__init__(config)\n"
        "        c = self.config\n"
        "        self.m = DeeplabV2(DeeplabV2Config.uemda_default(\n"
        "            c.num_classes, resnet_type=c.backbone.resnet_type),\n"
        "            device='cpu')\n"
        "    def set_default_config(self):\n"
        "        self.config.update(dict(num_classes=6, backbone=dict(\n"
        "            resnet_type='resnet50')))\n"
        "    def load_state_dict(self, sd, strict=True):\n"
        "        return self.m.load_state_dict(sd, strict)\n"
        "    def forward(self, x):\n"
        "        y = self.m(x)\n"
        "        return y if os.environ.get('EXACT') else 2 * y\n")
    (pkg / "_resnets.py").write_text("resnet18 = object()\n")
    (pkg / "resnet.py").write_text(
        "from ever.core import registry\n"
        "from ever.interface import ERModule\n"
        "from uemda_tpu_torch.models.config import BackboneConfig\n"
        "from uemda_tpu_torch.models.resnet import ResNetEncoder as R\n"
        "class ResNetEncoder(ERModule):\n"
        "    def __init__(self, config):\n"
        "        super().__init__(config)\n"
        "        assert self.config.resnet_type in registry.MODEL\n"
        "        self.resnet = R(BackboneConfig(\n"
        "            resnet_type=self.config.resnet_type,\n"
        "            output_stride=self.config.output_stride)).resnet\n"
        "    def set_default_config(self):\n"
        "        self.config.update(dict(output_stride=16))\n"
        "    def forward(self, x):\n"
        "        return self.resnet(x)\n")


@pytest.fixture
def fresh_modules():
    """Modules a test imports from a reference checkout (and the
    stand-ins it installs) leave ``sys.modules`` when it ends, so no later
    test in the process finds them."""
    tops = ("uemda",) + tuple(
        importlib.import_module("uemda_tpu_torch.tools.reference").STAND_INS)
    before = set(sys.modules)
    yield
    for name in set(sys.modules) - before:
        if name.split(".")[0] in tops:
            del sys.modules[name]


def test_gate_parity_stage_against_a_stand_in_reference(
        pair, tmp_path, capsys, monkeypatch, fresh_modules):
    """The parity stage imports the checkout at ``--reference-root`` with
    the stand-ins for missing packages (``ever`` here), builds its
    module from the reference's config dict, loads the state dict and
    compares on the same input: an exact stand-in passes (0 difference),
    a wrong one fails with ``"failed": "parity"``, and so does a missing
    checkout unless ``--skip-parity``; the imagenet kind compares the
    encoder's pyramid at output strides 16 and 8."""
    from uemda_tpu_torch.tools import real_data_gate as gate

    monkeypatch.setattr(sys, "path", list(sys.path))
    ref = tmp_path / "reference"
    _stand_in_reference(ref)
    argv = ["--torch-ckpt", pair.ckpt, "--kind", "deeplabv2",
            "--resnet-type", "resnet18", "--num-classes", str(C),
            "--device", "cpu", "--reference-root"]
    for root in ([str(tmp_path / "none")], [""]):
        with pytest.raises(SystemExit):
            gate.main(argv + root)
        rec = json.loads(capsys.readouterr().out)
        assert rec["failed"] == "parity" and "no reference" in \
            rec["parity_error"]
    with pytest.raises(SystemExit):   # the flag's default: no checkout
        gate.main(argv[:-1])
    assert json.loads(capsys.readouterr().out)["failed"] == "parity"
    assert gate.main(argv + [str(tmp_path / "none"), "--skip-parity"])["ok"]
    with pytest.raises(SystemExit):
        gate.main(argv + [str(ref)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["failed"] == "parity" and rec["parity_max_abs"] > 1e-3
    monkeypatch.setenv("EXACT", "1")
    rec = gate.main(argv + [str(ref)])
    assert rec["ok"] and rec["parity_max_abs"] == 0.0
    trunk = tmp_path / "trunk.pth"
    torch.save(pair.tmodel.encoder.resnet.state_dict(), trunk)
    for stride in ("16", "8"):
        rec = gate.main(["--torch-ckpt", str(trunk), "--resnet-type",
                         "resnet18", "--allow-unverified", "--device", "cpu",
                         "--output-stride", stride, "--reference-root",
                         str(ref)])
        assert rec["ok"] and rec["parity_max_abs"] < 1e-3, stride
    assert "ever" in sys.modules and not hasattr(sys.modules["ever"],
                                                 "__file__")


def test_gate_parity_against_the_live_reference(tmp_path, capsys):
    """Where the reference checkout exists (``tests/ref_oracle.py`` skips
    otherwise): a seeded flagship ``.pth`` passes the parity stage against
    the reference's own ``Deeplabv2`` at the JAX tool's 1e-3."""
    from tests.ref_oracle import REFERENCE_ROOT, ref_import
    from uemda_tpu_torch.tools import real_data_gate as gate

    ref_import("uemda.models.Encoder")
    model = gate.flagship(6, "resnet50", "cpu")
    ckpt = tmp_path / "flagship.pth"
    torch.save(model.state_dict(), ckpt)
    rec = gate.main(["--torch-ckpt", str(ckpt), "--kind", "deeplabv2",
                     "--device", "cpu", "--reference-root", REFERENCE_ROOT])
    assert rec["ok"] and rec["parity_max_abs"] < 1e-3

"""The CLIs of the other DA trainers on a tiny synthetic config with
``--device cpu``: ``train_adv`` resumed exactly, ``train_ssl_dca`` and
``train_ssl_uvem_abl`` over two chunks with a sweep between them, and the
data-parallel flags (ROADMAP A8) refused by all three."""

import importlib
import json
import logging
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_loop import _tiny_config
from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

TOOLS = ("train_adv", "train_ssl_dca", "train_ssl_uvem_abl")


def _main(tool):
    return importlib.import_module(f"uemda_tpu_torch.tools.{tool}").main


def _seeded_inputs(tmp_path, cfg_file):
    """A stage-2-like model and prototypes for the self-training tools."""
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.train.loop import build_model

    model = build_model(load_config(cfg_file), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "m.pth")
    np.save(tmp_path / "p.npy", np.random.default_rng(0).normal(
        size=(6, 512)).astype(np.float32))
    return ["--ckpt-model", str(tmp_path / "m.pth")]


def test_train_adv_resumes_exactly(tmp_path, monkeypatch):
    """``train_adv`` for 3 steps in one run, and for 2 steps then
    ``--steps 3 --resume auto`` (with ``--accum-steps 2``: the resumed run
    ends in the middle of an accumulation): the two runs end on bit-equal
    states -- the segmenter's masters, BatchNorm statistics, momentum and
    running mean, D's parameters and its Adam moments and count -- and the
    same ``metrics.jsonl`` losses."""
    monkeypatch.chdir(tmp_path)
    main = _main("train_adv")
    ends = {}
    for name, plan in (("once", [("3", "")]),
                       ("resumed", [("2", ""), ("3", "auto")])):
        cfg_file = _tiny_config(tmp_path / name)
        for steps, resume in plan:
            out = main(["--config-path", cfg_file, "--steps", steps,
                        "--device", "cpu", "--accum-steps", "2",
                        "--lambda-adv", "0.1", "--resume", resume])
        run_dir = tmp_path / name / "log" / "adv"
        assert out["step"] == 3
        snap = torch.load(run_dir / "state_curr.pth", weights_only=True)
        recs = [json.loads(x) for x in
                (run_dir / "metrics.jsonl").read_text().splitlines()]
        ends[name] = snap, recs
        assert (run_dir / "Vaihingen_best.pth").exists()
    (a, ra), (b, rb) = ends["once"], ends["resumed"]
    assert a["step"] == b["step"] == 3 and a["opt"]["count"] == 1
    assert a["opt"]["mini_step"] == 1 and float(a["d_opt"]["count"]) == 3

    def flat(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            return {prefix: tree}
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, (list, tuple)):
            items = enumerate(tree)
        else:
            return {prefix: torch.tensor(tree)}
        return {k: v for i, t in items for k, v in
                flat(t, f"{prefix}/{i}").items()}

    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys() and any("/disc/" in k for k in fa)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    loss = [r for r in ra if "loss_d" in r]
    assert loss and loss[-1] == [r for r in rb if "loss_d" in r][-1]
    shutil.rmtree(tmp_path / "once")
    shutil.rmtree(tmp_path / "resumed")


def _chunked_config(tmp_path):
    """``_tiny_config`` with ``GENE_EVERY`` 1."""
    cfg_file = _tiny_config(tmp_path)
    text = open(cfg_file).read().rstrip("\n")
    assert text.endswith(")")
    with open(cfg_file, "w") as f:
        f.write(text[:-1] + ", gene_every=1)\n")
    return cfg_file


@pytest.mark.parametrize("tool", ["train_ssl_dca", "train_ssl_uvem_abl"])
def test_self_training_tools_run_two_chunks(tmp_path, monkeypatch, caplog,
                                            tool):
    """``train_ssl_dca`` (``--bcs 1``) and ``train_ssl_uvem_abl`` (refine
    'all', so the superpixel maps are read) for 2 steps at ``GENE_EVERY``
    1: a sweep, a step, a sweep at step 1, a step; each chunk evaluates at
    its end; the soft labels in the tool's pseudo-label dir (beside the
    run dir for DCA, inside it for the ablation, whose run dir names the
    swept triple); the last snapshot at step 2."""
    monkeypatch.chdir(tmp_path)
    caplog.set_level(logging.INFO, logger=f"uemda_tpu_torch.{tool}")
    cfg_file = _chunked_config(tmp_path)
    argv = ["--config-path", cfg_file, "--steps", "2", "--device", "cpu"]
    argv += _seeded_inputs(tmp_path, cfg_file)
    if tool == "train_ssl_dca":
        argv += ["--bcs", "1"]
        run_dir = tmp_path / "log" / "dca"
        pseudo = tmp_path / "log" / "pseudo_label"
    else:
        argv += ["--ckpt-proto", str(tmp_path / "p.npy"), "--uvem-g", "4"]
        run_dir = tmp_path / "log" / "ssl-abl-m0.2-t0.7-g4.0-uvem"
        pseudo = run_dir / "pseudo_label"
    out = _main(tool)(argv)
    assert out["step"] == 1     # the last chunk's own count
    msgs = caplog.messages
    assert [m for m in msgs if "regenerating" in m] == [
        "###### regenerating pseudo labels @ step 1 ######"]
    assert sum(m.startswith("eval@1") for m in msgs) == 2
    assert len(list(pseudo.glob("*.npy"))) == 4
    snap = torch.load(run_dir / "state_curr.pth", weights_only=True)
    assert snap["step"] == snap["opt"]["count"] == 2
    if tool == "train_ssl_dca":
        assert not np.allclose(snap["balance_s"]["freq"].numpy(), 1 / 6)
    shutil.rmtree(tmp_path / "log")


@pytest.mark.parametrize("tool", TOOLS)
@pytest.mark.parametrize("flag", [["--num-devices", "2"], ["--multihost", "1"],
                                  ["--process-id", "0"]])
def test_data_parallel_flags_are_refused(tool, flag, monkeypatch):
    """The data-parallel flags, refused until the port's data parallelism
    (this name kept from then), are taken as the JAX tools take them, the
    trainer's body (``_run``) stubbed: ``--num-devices 2`` goes to the
    launcher, which starts 2 processes; ``--multihost 1`` with a
    coordinator, 1 process and rank 0 runs the body in a gloo group of
    one, torn down after; ``--process-id 0`` without ``--multihost`` is
    ignored, as ``setup_multihost`` ignores it: one process, no group."""
    import socket

    import torch.distributed as dist

    from uemda_tpu_torch.parallel import mesh, multihost

    mod = importlib.import_module(f"uemda_tpu_torch.tools.{tool}")
    seen = []
    monkeypatch.setattr(mod, "_run", lambda a: seen.append(
        (a, mesh.world_size(), mesh.backend())) or "ran")
    spawned = []
    monkeypatch.setattr(multihost, "_spawn", lambda fn, a, n: spawned.append(
        (fn, a, n)))
    argv = ["--device", "cpu", "--ckpt-model", "x.pth"] + flag
    if tool == "train_ssl_uvem_abl":
        argv += ["--ckpt-proto", "p.npy"]
    if flag[0] == "--multihost":
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        argv += ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
                 "--process-id", "0"]
    out = _main(tool)(argv)
    if flag[0] == "--num-devices":
        assert out is None and not seen
        (fn, args, n), = spawned
        assert fn is mod._run and n == 2 and args.num_devices == 2
        return
    assert out == "ran" and not spawned
    (args, world, backend), = seen
    if flag[0] == "--multihost":
        assert (world, backend) == (1, "gloo") and args.multihost == 1
    else:
        assert (world, backend) == (1, None) and args.process_id == 0
    assert not dist.is_initialized()


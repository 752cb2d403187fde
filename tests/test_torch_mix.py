"""The mix and combo self-training of the port on the CPU against the JAX
package: the mixing ops exactly, on draws pinned from JAX's keys; two
``make_mix_step`` steps for legacy CutMix and for the combo (ClassMix,
UVEM, refine 'all', target class balance); the ``train_ssl_mix`` chunk,
resume and regeneration schedule against the JAX tool's on a toy step;
and the CLI on a tiny config, resumed."""

import dataclasses
import importlib
import itertools
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_ssl_step import (
    CROP,
    HW,
    NORM,
    _batches,
    _no_dropout,
    _states,
    _updates_close,
)
from tests.torch_port_helpers import jax_and_torch_models, jax_aug_draws
from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from tests.torch_port_helpers import jax_mix_draws
from uemda_tpu.ops import mixing as jax_mixing
from uemda_tpu.ops.labels import one_hot_ignore as jax_one_hot
from uemda_tpu.train.steps import StageHParams as JaxHParams
from uemda_tpu.train.steps import make_mix_step as jax_make_mix_step
from uemda_tpu_torch.ops import mixing
from uemda_tpu_torch.ops.labels import one_hot_ignore
from uemda_tpu_torch.train.steps import (
    MixStepDraws,
    StageHParams,
    make_mix_step,
)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

C = 6


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _mix_inputs(seed, b=3, hw=16):
    r = np.random.default_rng(seed)
    label_s = r.integers(-1, C, (b, hw, hw)).astype(np.int32)
    label_t = r.integers(-1, C, (b, hw, hw)).astype(np.int32)
    img_s = r.normal(size=(b, hw, hw, 3)).astype(np.float32)
    img_t = r.normal(size=(b, hw, hw, 3)).astype(np.float32)
    prob_t = r.random((b, hw, hw, C)).astype(np.float32)
    prob_s = np.asarray(jax_one_hot(jnp.asarray(label_s), C, -1))
    return img_s, label_s, img_t, label_t, prob_s, prob_t


def _assert_same(got, want):
    """Port outputs (NCHW images and soft maps) against JAX's (NHWC)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.permute(0, 2, 3, 1) if g.dim() == 4 else g
        np.testing.assert_array_equal(g.numpy(), w)


def test_box_mask_rounds_half_to_even_as_jax():
    """Box edges that land on .5 (lam 0.75 halves the side; centres at
    .5): rounded half to even, as ``jnp.round``, and clipped to the image;
    and boxes from random draws. Bit-equal to the JAX package's."""
    cases = [(0.75, 4.5, 5.5), (0.75, 5.5, 2.5), (0.75, 0.5, 15.5),
             (0.0, 8.0, 8.0), (1.0, 3.0, 3.0)]
    r = np.random.default_rng(0)
    cases += [tuple(r.random(3) * [1.0, 16.0, 16.0]) for _ in range(20)]
    for lam, cx, cy in cases:
        want = np.asarray(jax_mixing.box_mask(
            (16, 16), jnp.float32(lam), jnp.float32(cx), jnp.float32(cy)))
        got = mixing.box_mask((16, 16), *(torch.tensor(v, dtype=torch.float32)
                                          for v in (lam, cx, cy)))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=str((lam, cx, cy)))
    got = mixing.box_mask((16, 16), torch.tensor(0.75), torch.tensor(4.5),
                          torch.tensor(5.5))
    rows, cols = np.nonzero(got.numpy())
    assert (cols.min(), cols.max(), rows.min(), rows.max()) == (0, 7, 2, 9)


def test_mixers_match_jax_on_pinned_draws():
    """``classmix_paste``, ``classmix`` and ``cutmix`` with and without the
    soft maps (the 5th and 6th elements: the pasted soft map and the paste
    mask), and ``cutmix_inbatch``, each on the draws the JAX function
    derives from its key: bit-equal."""
    img_s, label_s, img_t, label_t, prob_s, prob_t = _mix_inputs(1)
    j = [jnp.asarray(a) for a in (img_s, label_s, img_t, label_t)]
    t = [_nchw(img_s), torch.from_numpy(label_s), _nchw(img_t),
         torch.from_numpy(label_t)]
    probs_j = dict(probs_s=jnp.asarray(prob_s), probs_t=jnp.asarray(prob_t))
    probs_t = dict(probs_s=_nchw(prob_s), probs_t=_nchw(prob_t))
    sel = np.array([1, 0, 0, 1, 1, 0], np.float32)
    _assert_same(mixing.classmix_paste(torch.from_numpy(sel), *t, C, -1,
                                       **probs_t),
                 jax_mixing.classmix_paste(jnp.asarray(sel), *j, C, -1,
                                           **probs_j))
    for seed in range(3):
        key = jax.random.key(seed)
        d_c = jax_mix_draws(key, "classmix", (16, 16), C)
        d_b = jax_mix_draws(key, "cutmix", (16, 16), C)
        assert 0 < float(d_b.lam) < 1 and int(d_c.selected.sum()) == C // 2
        for kw_t, kw_j in (({}, {}), (probs_t, probs_j)):
            _assert_same(mixing.classmix(d_c, *t, C, -1, **kw_t),
                         jax_mixing.classmix(key, *j, ratio=0.5, class_num=C,
                                             ignore_label=-1, **kw_j))
            _assert_same(mixing.cutmix(d_b, *t, **kw_t),
                         jax_mixing.cutmix(key, *j, **kw_j))
        d_i = jax_mix_draws(key, "cutmix", (16, 16), C, batch=3)
        _assert_same(mixing.cutmix_inbatch(d_i, t[0], t[1]),
                     jax_mixing.cutmix_inbatch(key, j[0], j[1]))
    # the port's one-hot of the source label is JAX's
    np.testing.assert_array_equal(
        one_hot_ignore(torch.from_numpy(label_s), C).numpy(), prob_s)


def test_draw_mix_is_a_function_of_the_generator():
    """The host draws: ClassMix picks int(C * ratio) classes; CutMix's
    ``lam`` lies in (0, 1) and its centre in the image; the same generator
    state gives the same draws."""
    draws = [mixing.draw_mix(torch.Generator().manual_seed(s), m, (16, 24),
                             7, batch=4)
             for s in (0, 0, 1) for m in ("classmix", "cutmix")]
    assert int(draws[0].selected.sum()) == 3
    assert 0 < float(draws[1].lam) < 1
    assert 0 <= float(draws[1].cx) < 24 and 0 <= float(draws[1].cy) < 16
    assert sorted(draws[1].perm.tolist()) == [0, 1, 2, 3]
    for a, b in zip(draws[:2], draws[2:4]):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None and y is None) or torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown mix"):
        mixing.draw_mix(torch.Generator(), "mixup", (16, 16))


MIX_CASES = {
    # the reference's trainer: mined labels, CE on both mixed batches, the
    # target's CE weighted by the source balance before the step's update
    "legacy cutmix": dict(mix="cutmix", combo=False,
                          hp=dict(refine=False, target_loss="ce",
                                  balance_source=True)),
    "combo classmix": dict(mix="classmix", combo=True,
                           hp=dict(refine=True, refine_mode="all",
                                   target_loss="uvem", balance_target=True)),
}


@pytest.mark.parametrize("case", list(MIX_CASES))
def test_two_mix_steps_match_jax(monkeypatch, case):
    """Two ``make_mix_step`` steps from the same weights, prototypes,
    batches and draws (augmentation and mix from JAX's keys), dropout off
    on both sides: resnet18, 72^2 uint8 tiles cropped to 64^2, batch 2,
    f32. The losses 1e-4 relative; the prototypes within 1e-5 of their
    largest entry and the class balances 1e-6 relative; the updates and
    statistics as the stage-3 test's ``_updates_close``."""
    spec = MIX_CASES[case]
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = jax_and_torch_models("resnet18", CROP, seed=1)
    proto = np.random.default_rng(3).normal(size=(C, 512)).astype(np.float32)
    jstate, state = _states(variables, tmodel, prototypes=proto)
    hp = dict(class_num=C, crop=(CROP, CROP), compute_dtype="float32",
              clamp_target=True, max_segments=64, **NORM, **spec["hp"])
    jstep = jax_make_mix_step(jmodel, JaxHParams(**hp), mix=spec["mix"],
                              combo=spec["combo"])
    step = make_mix_step(tmodel, StageHParams(**hp), mix=spec["mix"],
                         combo=spec["combo"])
    for i in range(2):
        img, label, tgt, sup, prob = _batches(10 + i)
        key = jax.random.key(20 + i)
        jstate, jm = jstep(
            jstate, {"image": jnp.asarray(img), "label": jnp.asarray(label)},
            {"image": jnp.asarray(tgt), "sup": jnp.asarray(sup),
             "prob": jnp.asarray(prob.astype(np.float32))}, key)
        k_aug_s, k_aug_t, k_mix = jax.random.split(key, 5)[:3]
        draws = MixStepDraws(
            jax_aug_draws(k_aug_s, 2, (HW, HW), (CROP, CROP)),
            jax_aug_draws(k_aug_t, 2, (HW, HW), (CROP, CROP), "compose"),
            mix=jax_mix_draws(k_mix, spec["mix"], (CROP, CROP), C))
        tm = step(state, {"image": torch.from_numpy(img),
                          "label": torch.from_numpy(label)},
                  {"image": torch.from_numpy(tgt), "sup": torch.from_numpy(sup),
                   "prob": torch.from_numpy(prob)}, 0, draws=draws)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        assert float(tm["loss_target"]) > 0.01
        for name in ("balance_s", "balance_t"):
            np.testing.assert_allclose(
                getattr(state, name).freq.numpy(),
                np.asarray(getattr(jstate, name).freq), rtol=1e-6)
    assert state.step == int(jstate.step) == 2
    want = np.asarray(jstate.aligner.prototypes)
    got = state.aligner.prototypes.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if spec["combo"]:
        assert np.abs(got - proto).max() > 1e-3    # the EMA really moved
        assert not np.allclose(state.balance_t.freq.numpy(), 1.0 / C)
    else:
        assert not np.allclose(state.balance_s.freq.numpy(), 1.0 / C)
    _updates_close(tmodel, jstate, variables)


def test_mining_forward_leaves_the_batchnorm_statistics():
    """The combo's mining forward (train mode, no gradient) runs on
    scratch copies of the BatchNorm buffers: the model's own statistics
    stay as they were, as the JAX step throws that forward's update
    away."""
    from uemda_tpu_torch.train.steps import forward_scratch

    _, _, tmodel = jax_and_torch_models("resnet18", CROP, seed=1)
    tmodel.train()
    before = {n: b.clone() for n, b in tmodel.named_buffers()}
    x = torch.randn(2, 3, CROP, CROP).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        out = forward_scratch(tmodel, None, x, None)
    assert len(out) == 3 and all(torch.isfinite(t).all() for t in out)
    for n, b in tmodel.named_buffers():
        assert torch.equal(b, before[n]), n


# ------------------------------------------------------ the mix CLI


def _jax_loop():
    from uemda_tpu.train import loop

    return loop


def _mix_cli_runs(tmp_path, monkeypatch, gen, crash):
    """The JAX tool's ``main`` and the port's, on a toy counter step
    (``test_torch_resume``'s), 23 steps in chunks of ``GENE_EVERY`` 10,
    evaluations every 7: every model, state, stream, sweep and evaluation
    replaced by a toy, the tools' own chunk, seed, resume and sweep logic
    and both packages' ``run_training_loop`` and ``maybe_resume`` left as
    they are. With ``crash``, the evaluation at that step dies (after its
    snapshot), and the tool runs again with ``--resume auto``. Returns,
    per package: the ``iter=``, ``eval@`` and sweep lines, the
    ``metrics.jsonl`` records, ``best.json``, the snapshots' steps and the
    last snapshot's toy parameter."""
    from uemda_tpu import config as jax_config
    from uemda_tpu.train import checkpoints as jax_ckpt
    from uemda_tpu_torch import config as torch_config
    from uemda_tpu_torch.tools import train_ssl_mix
    from uemda_tpu_torch.train import checkpoints
    from tests.test_torch_resume import (
        _JaxToy,
        _SyncSaver,
        _TorchToy,
        _jax_toy_step,
        _logger,
        _miou,
        _stream,
        _torch_toy_step,
    )

    sys.path.insert(0, str(Path(__file__).parents[1]))
    jtool = importlib.import_module("tools.train_ssl_mix")
    snaps = {"jax": [], "port": []}
    save_j, save_t = jax_ckpt.save_checkpoint, checkpoints.save_checkpoint

    def rec_j(path, state):
        snaps["jax"].append(int(state.step))
        return save_j(path, state)

    def rec_t(path, obj):
        snaps["port"].append(int(obj["step"]))
        return save_t(path, obj)

    def target(ds, bs, seed, skip_batches, **kw):
        for i in itertools.count(skip_batches):
            yield {"x": np.array([100 + i % 5], np.float32)}

    def config(module, name):
        def load(path, snapshot_postfix=""):
            return dataclasses.replace(
                module.PRESETS["2vaihingen"], gene_every=10, eval_every=7,
                stage3_steps=23,
                snapshot_dir=str(tmp_path / name) + snapshot_postfix)
        return load

    dying = {"on": False}

    def evaluate(state):
        if dying["on"] and int(state.step) == crash:
            raise OSError("crash")
        return _miou(state.step)

    def hook(*a, **k):
        return evaluate, None

    jlog, jlines = _logger(f"mix-jax-{gen}-{crash}")
    tlog, tlines = _logger("uemda_tpu_torch.train_ssl_mix")
    patches = (
        (jax_ckpt, dict(save_checkpoint=rec_j, AsyncSaver=_SyncSaver)),
        (_jax_loop(), dict(save_checkpoint=rec_j)),
        (checkpoints, dict(save_checkpoint=rec_t)),
        (jtool, dict(
            load_config=config(jax_config, "jax"),
            get_console_file_logger=lambda name, d: jlog,
            build_model=lambda cfg: type("M", (), {"config": type(
                "C", (), {"inchannels": 512})})(),
            init_variables=lambda model, cfg, seed: None,
            load_checkpoint=lambda path, target: target,
            build_state=lambda *a, **k: _JaxToy(
                jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32)),
            make_mix_step=lambda *a, **k: _jax_toy_step,
            make_source_iter=lambda cfg, skip, host_crop: (_stream(skip),
                                                           None),
            SegDataset=lambda *a, **k: None, infinite_batches=target,
            variables_of=lambda s: s, make_eval_hook=hook,
            generate_pseudo_labels=lambda *a, **k: jlines.append("sweep"))),
        (train_ssl_mix, dict(
            load_config=config(torch_config, "port"),
            build_model=lambda cfg, device: torch.nn.Linear(1, 1),
            load_checkpoint=lambda p: torch.nn.Linear(1, 1).state_dict(),
            build_state=lambda model, *a, **k: _TorchToy(0, model,
                                                         torch.zeros(())),
            make_mix_step=lambda *a, **k: _torch_toy_step,
            make_source_iter=lambda cfg, skip, host_crop: (_stream(skip),
                                                           None),
            SegDataset=lambda *a, **k: None, infinite_batches=target,
            make_eval_hook=hook,
            generate_pseudo_labels=lambda *a, **k: tlines.append("sweep"))))
    for mod, attrs in patches:
        for k, v in attrs.items():
            monkeypatch.setattr(mod, k, v)
    argv = ["--ckpt-model", "m", "--mix", "classmix", "--gen", str(gen)]
    runs = (("jax", lambda a: (monkeypatch.setattr(sys, "argv", ["t"] + a),
                               jtool.main())),
            ("port", lambda a: train_ssl_mix.main(a + ["--device", "cpu"])))
    for resume in ("", "auto") if crash else ("",):
        dying["on"] = bool(crash) and not resume
        for name, run in runs:
            if dying["on"]:
                with pytest.raises(OSError, match="crash"):
                    run(argv + ["--resume", resume])
            else:
                run(argv + ["--resume", resume])
    out = {}
    for name, lines, snap in (("jax", jlines, "state_curr.msgpack"),
                              ("port", tlines, "state_curr.pth")):
        run_dir = tmp_path / name / "classmix"
        last = (float(torch.load(run_dir / snap)["params"]) if name == "port"
                else None)
        out[name] = dict(
            lines=[x for x in lines
                   if x.startswith(("iter=", "eval@", "sweep", "######"))],
            jsonl=[json.loads(x) for x in
                   (run_dir / "metrics.jsonl").read_text().splitlines()],
            best=json.loads((run_dir / "best.json").read_text()),
            snaps=list(snaps[name]), last=last)
    return out


def _comparable(run):
    """A run's records without the toy's batch sums and parameter (the JAX
    tool shares one source stream between its chunks, whose upload stage
    reads ahead, so JAX's batches after a chunk are not the step's; the
    port's are), and its snapshot steps without repeats (``distinct``)."""
    from tests.test_torch_resume import distinct

    return dict(run, last=None, snaps=distinct(run["snaps"]),
                lines=[re.sub(r", x=[^,]*$", "", x) for x in run["lines"]],
                jsonl=[{k: v for k, v in r.items() if k != "x"}
                       for r in run["jsonl"]])


@pytest.mark.parametrize("gen", [1, 0])
def test_mix_cli_chunks_resume_and_sweeps_match_jax(tmp_path, monkeypatch,
                                                    gen):
    """``train_ssl_mix``'s chunks against the JAX tool's
    (``_mix_cli_runs``), uninterrupted and killed in the evaluation of step
    17 (its snapshot written) then resumed: the same log, evaluation and
    sweep lines -- each chunk counts from its start, so evaluations fall
    at its step 7 and at its end -- the same ``metrics.jsonl`` steps and
    keys, ``best.json`` and snapshot steps. With ``--gen 1`` a sweep opens
    the run and one follows each chunk but the last; the resumed run
    sweeps before its first live chunk, as JAX's. The port's resumed run
    ends on the uninterrupted one's state and records, batch sums
    included: its streams start at each chunk's step."""
    full = _mix_cli_runs(tmp_path / "full", monkeypatch, gen, None)
    cut = _mix_cli_runs(tmp_path / "cut", monkeypatch, gen, 17)
    for run in (full, cut):
        assert _comparable(run["port"]) == _comparable(run["jax"])
    f, c = full["port"], cut["port"]
    assert c["last"] == f["last"] and c["jsonl"][-3:] == f["jsonl"][-3:]
    assert f["snaps"] == [7, 10, 17, 20, 23]
    assert c["snaps"] == [7, 10, 17, 17, 20, 23]
    regen = [f"###### regenerating pseudo labels @ step {s} ######"
             for s in (10, 20)]
    sweeps = [x for x in f["lines"] if x.startswith(("sweep", "###"))]
    assert sweeps == (["sweep", regen[0], "sweep", regen[1], "sweep"] if gen
                      else ["sweep"])
    sweeps = [x for x in c["lines"] if x.startswith(("sweep", "###"))]
    assert sweeps == (["sweep", regen[0], "sweep", regen[0], "sweep",
                       regen[1], "sweep"] if gen else ["sweep", "sweep"])
    assert [x for x in f["lines"] if x.startswith("eval@")] == [
        "eval@7: mIoU=0.90000 (best 0.90000 @ iter 7)",
        "eval@10: mIoU=0.00000 (best 0.90000 @ iter 7)",
        "eval@7: mIoU=0.90000 (best 0.90000 @ iter 7)",
        "eval@10: mIoU=0.00000 (best 0.90000 @ iter 7)",
        "eval@3: mIoU=0.10000 (best 0.90000 @ iter 7)"]


def test_mix_cli_runs_and_resumes_on_the_cpu(tmp_path, monkeypatch):
    """``train_ssl_mix --mix classmix --lt uvem --refine-label 1 --device
    cpu`` (the combo) on a tiny synthetic config (resnet18, 64^2 crops of
    80^2 tiles, ``GENE_EVERY`` 4) for 3 steps, then ``--steps 6 --resume
    auto``: the second run restores step 3, sweeps the target with the
    restored model, ends chunk 1 at step 4, sweeps again and ends at step
    6; each run leaves its snapshot, the best model, ``best.json`` and
    ``metrics.jsonl``, and the soft labels of every target tile. The
    multi-process flags are taken: ``--multihost 1`` (a gloo group of one
    process) resumes to step 7 with a sweep first, and ``--num-devices 2``
    goes to the launcher's 2 processes."""
    from tests.test_torch_pipeline import _tiny_config
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.tools import train_ssl_mix
    from uemda_tpu_torch.train.checkpoints import load_checkpoint
    from uemda_tpu_torch.train.loop import build_model

    monkeypatch.chdir(tmp_path)
    cfg_file = _tiny_config(tmp_path)
    with open(cfg_file, "a") as f:
        f.write("CONFIG = dataclasses.replace(CONFIG, gene_every=4)\n")
    model = build_model(load_config(cfg_file), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "m.pth")
    np.save(tmp_path / "p.npy", np.random.default_rng(0).normal(
        size=(C, 512)).astype(np.float32))
    sweeps = []
    real = train_ssl_mix.generate_pseudo_labels
    monkeypatch.setattr(train_ssl_mix, "generate_pseudo_labels",
                        lambda *a, **k: (sweeps.append(1), real(*a, **k))[1])
    argv = ["--config-path", cfg_file, "--ckpt-model", str(tmp_path / "m.pth"),
            "--ckpt-proto", str(tmp_path / "p.npy"), "--mix", "classmix",
            "--lt", "uvem", "--refine-label", "1", "--device", "cpu",
            "--host-crop", "1", "--steps-per-call", "2"]
    run_dir = tmp_path / "log" / "classmix"
    out = train_ssl_mix.main(argv + ["--steps", "3"])
    assert out["step"] == 3 and len(sweeps) == 1
    assert load_checkpoint(str(run_dir / "state_curr.pth"))["step"] == 3
    out = train_ssl_mix.main(argv + ["--steps", "6", "--resume", "auto"])
    assert len(sweeps) == 3 and 0.0 <= out["miou"] <= 1.0
    snap = load_checkpoint(str(run_dir / "state_curr.pth"))
    assert snap["step"] == snap["opt"]["count"] == 6
    recs = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], "miou" in r) for r in recs] == [
        (1, False), (3, True), (4, True), (1, False), (2, True)]
    assert json.loads((run_dir / "best.json").read_text())["step"] in (2, 3, 4)
    assert (run_dir / "Vaihingen_best.pth").exists()
    assert (run_dir / "Vaihingen_curr.pth").exists()
    assert len(list((tmp_path / "log" / "pseudo_label").glob("*.npy"))) == 4
    import socket

    import torch.distributed as dist

    from uemda_tpu_torch.parallel import multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = train_ssl_mix.main(argv + [
        "--steps", "7", "--resume", "auto", "--multihost", "1",
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
        "--process-id", "0"])
    assert not dist.is_initialized() and len(sweeps) == 4
    assert load_checkpoint(str(run_dir / "state_curr.pth"))["step"] == 7
    spawned = []
    monkeypatch.setattr(multihost, "_spawn",
                        lambda fn, a, n: spawned.append((fn, n)))
    assert train_ssl_mix.main(argv + ["--num-devices", "2"]) is None
    assert spawned == [(train_ssl_mix._run, 2)]
    shutil.rmtree(tmp_path / "log")  # ~0.7 GB of checkpoints

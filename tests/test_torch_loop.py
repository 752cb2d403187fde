"""The training loop's host path in the port on the CPU: the decode prefetch
against the JAX package's, the host crop against JAX's ``infinite_batches``,
the chunk schedule of ``steps_per_call`` and the profiler window against
JAX's ``run_training_loop``, the device-tensor augmentation against the
per-sample path it replaced, chunked steps against single ones, and the
three trainer CLIs with the loop flags. The captured CUDA graph itself is
tested on the card (test_torch_gpu.py)."""

import dataclasses
import itertools
import logging
import shutil
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from uemda_tpu.datasets.base import SegDataset as JaxSegDataset
from uemda_tpu.datasets.base import infinite_batches as jax_infinite_batches
from uemda_tpu.datasets.prefetch import prefetch as jax_prefetch
from uemda_tpu.train import loop as jax_loop
from uemda_tpu_torch.datasets.augment import (
    AugDraws,
    _d4,
    augment_batch,
)
from uemda_tpu_torch.datasets.base import (
    ArrayDataset,
    SegDataset,
    infinite_batches,
)
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.prefetch import prefetch
from uemda_tpu_torch.datasets.synthetic import (
    make_synthetic_dataset,
    synthetic_split,
)
from uemda_tpu_torch.ops.crop import crop_normalize_plain
from uemda_tpu_torch.train.loop import run_training_loop

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

MEAN, STD = (120.0, 82.0, 81.0), (55.0, 39.0, 38.0)


# ------------------------------------------------------------ the prefetch


class _Source:
    """An iterator of 0, 1, 2, ... that counts what it handed out and
    raises after ``fail_at`` items."""

    def __init__(self, fail_at=None):
        self.pulled = 0
        self.fail_at = fail_at

    def __iter__(self):
        return self

    def __next__(self):
        if self.fail_at is not None and self.pulled == self.fail_at:
            raise OSError("corrupt tile")
        self.pulled += 1
        return self.pulled - 1


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_matches_jax(depth):
    """Order, the bound on what the worker reads ahead (the consumed item,
    ``depth`` queued and one held), and a worker's error raised in the
    consumer after the items before it, as the JAX package's prefetch;
    closing the port's stops its worker, and the source reads on."""
    runs = {}
    for name, fn in (("port", prefetch), ("jax", jax_prefetch)):
        src = _Source()
        it = fn(src, depth=depth)
        first = next(it)
        time.sleep(0.3)  # the worker fills the queue and blocks
        ahead = src.pulled
        runs[name] = ([first] + [next(it) for _ in range(9)], ahead)
        if name == "port":
            it.close()  # joins the worker
            pulled = src.pulled
            time.sleep(0.2)
            assert next(src) == pulled  # no worker reads it any more
    assert runs["port"] == runs["jax"] == (list(range(10)), depth + 2)
    for fn in (prefetch, jax_prefetch):
        got = []
        with pytest.raises(OSError, match="corrupt"):
            for x in fn(_Source(fail_at=3), depth=depth):
                got.append(x)
        assert got == [0, 1, 2]


# ----------------------------------------------------------- the host crop


def _prob_dir(tmp_path, names, hw, seed):
    """fp16 soft labels, one ``<image name>.npy`` a tile, as the sweep
    writes them."""
    r = np.random.default_rng(seed)
    d = tmp_path / "prob"
    d.mkdir()
    for n in names:
        p = r.random((hw, hw, 6)).astype(np.float16)
        np.save(d / f"{n}.npy", p)
    return str(d)


@pytest.mark.parametrize("skip", [0, 3])
def test_host_crop_matches_jax_on_disk(tmp_path, skip):
    """``infinite_batches(host_crop=...)`` on a split on disk: image,
    label, superpixel and soft-label batches equal the JAX package's at the
    same seed and skip (the soft labels stay fp16 in the port, f32 in JAX:
    the same values); without the crop the whole tiles, as before."""
    img, ann = make_synthetic_dataset(str(tmp_path / "d"), IsprsDA,
                                      n_train=5, n_val=1, hw=48, seed=1)
    names = sorted(p.name for p in (tmp_path / "d").rglob("train/*.png")
                   if "img_dir" in str(p))
    prob = _prob_dir(tmp_path, names, 48, 2)
    pairs = [
        (SegDataset(IsprsDA, [img], ann, read_sup=True),
         JaxSegDataset(IsprsDA, [img], ann, read_sup=True)),
        (SegDataset(IsprsDA, [img], prob, label_type="prob"),
         JaxSegDataset(IsprsDA, [img], prob, label_type="prob")),
    ]
    for ds, jds in pairs:
        for crop in ((32, 32), None):
            got = infinite_batches(ds, 2, seed=7, skip_batches=skip,
                                   host_crop=crop)
            want = jax_infinite_batches(jds, 2, seed=7, skip_batches=skip,
                                        host_crop=crop)
            for _ in range(4):
                g, w = next(got), next(want)
                assert sorted(g) == sorted(w)
                for k in g:
                    assert g[k].shape[1:3] == (crop or (48, 48))
                    np.testing.assert_array_equal(
                        g[k].astype(w[k].dtype), w[k], err_msg=k)


def test_host_crop_matches_jax_in_memory():
    """The in-memory split: views of each sample cropped, then stacked, at
    the JAX package's origins (JAX's stream reads the same split through
    its ``item``); a tile smaller than the crop raises with its name."""
    data = synthetic_split(IsprsDA, n=5, hw=48, seed=4, with_sup=True)
    r = np.random.default_rng(0)
    data.prob = r.random((5, 48, 48, 6)).astype(np.float16)
    for skip in (0, 2):
        got = infinite_batches(data, 2, seed=3, skip_batches=skip,
                               host_crop=(24, 24))
        want = jax_infinite_batches(data, 2, seed=3, skip_batches=skip,
                                    host_crop=(24, 24))
        for _ in range(3):
            g, w = next(got), next(want)
            assert sorted(g) == ["image", "label", "prob", "sup"]
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    small = ArrayDataset(IsprsDA, data.images[:, :20, :20])
    with pytest.raises(ValueError, match="tile_00[0-4].png is 20x20"):
        next(infinite_batches(small, 2, host_crop=(24, 24)))


# ------------------------------------------------------ the chunk schedule


class _JaxToy(NamedTuple):
    params: jnp.ndarray
    count: jnp.ndarray


@jax.jit
def _jax_toy_step(state, bs, bt, key):
    del key
    c = state.count + 1
    return (_JaxToy(state.params + bs["x"].sum(), c),
            {"count": c.astype(jnp.float32), "x": bs["x"].sum() + bt["x"].sum()})


@dataclasses.dataclass
class _TorchToy:
    step: int
    model: torch.nn.Module


def _torch_toy_step(state, bs, bt, seed):
    state.step += 1
    return {"count": torch.tensor(float(state.step)),
            "x": bs["x"].sum() + bt["x"].sum()}


def _stream():
    for i in itertools.count():
        yield {"x": np.array([i % 7], np.float32)}


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    log = logging.getLogger(name)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    log.handlers[:] = [_Lines()]
    return log, log.handlers[0].lines


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("profile", [False, True])
def test_chunk_schedule_matches_jax(tmp_path, monkeypatch, k, profile):
    """The port's ``run_training_loop`` and JAX's, each on a toy counter
    step, 23 steps with logs every 5 and evaluations every 7 (not
    multiples of K): the same chunks -- step 1 alone, a chunk only where K
    steps fit before every boundary, single steps until the profiler's
    window (steps 10-15) is written -- and the same log and evaluation
    lines, with each logged step's own metrics."""
    chunks = []
    make = jax_loop._make_multi_step

    def recording(step_fn, with_target):
        multi = make(step_fn, with_target)

        def call(state, bs, bt, key0, i0):
            chunks.append((int(i0), int(bs["x"].shape[0])))
            return multi(state, bs, bt, key0, i0)
        return call

    monkeypatch.setattr(jax_loop, "_make_multi_step", recording)
    jlog, jlines = _logger(f"jax-{k}-{profile}")
    hooks = jax_loop.LoopHooks(eval_every=7, log_every=5, steps_per_call=k,
                               eval_fn=lambda s: float(s.count) / 100,
                               hang_timeout_s=0)
    state = _JaxToy(jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32))
    jax_loop.run_training_loop(
        state, _jax_toy_step, _stream(), _stream(), 23, jlog, hooks,
        profile_dir=str(tmp_path / "jax") if profile else None)

    tlog, tlines = _logger(f"torch-{k}-{profile}")
    toy = _TorchToy(0, torch.nn.Linear(1, 1))
    out = run_training_loop(
        toy, _torch_toy_step, _stream(), _stream(), 23, tlog, eval_every=7,
        log_every=5, eval_fn=lambda s: s.step / 100, steps_per_call=k,
        profile_dir=str(tmp_path / "torch") if profile else None)
    assert toy.step == 23 and out["graph"] is None

    def lines(ls):
        return [x for x in ls if x.startswith(("iter=", "eval@"))]

    assert lines(tlines) == lines(jlines)
    assert [x for x in lines(tlines) if x.startswith("iter=")][:2] == [
        "iter=1/23, count=1, x=0", "iter=5/23, count=5, x=8"]
    port_chunks = [(int(a) - 1, int(b) - int(a) + 1) for a, b in (
        x.split()[1].split("-") for x in tlines
        if x.startswith("steps ") and x.endswith("in one call"))]
    assert port_chunks == chunks
    if k == 1:
        assert chunks == []
    elif profile:
        assert chunks and all(i0 >= 15 for i0, _ in chunks)
    else:
        assert chunks[0] == (1, 3) and len(chunks) == 4
    if profile:
        assert (tmp_path / "torch" / "trace.json").exists()
        assert any("profiler trace written" in x for x in tlines)


# -------------------------------------------- device-tensor augmentation


def _per_sample(batch, crop_hw, mean, std, draws, clamp=False):
    """The augmentation as it was before its draws stayed on the device:
    K9's plain version, then a per-sample D4 op branched on the host, and
    each other array sliced at the host's origins."""
    th, tw = crop_hw
    image = crop_normalize_plain(batch["image"], draws.offsets, crop_hw,
                                 mean, std, clamp)
    d4 = draws.d4.tolist()
    out = {"image": torch.stack([_d4(image[i], d4[i], draws.mode, (1, 2))
                                 for i in range(len(d4))])
           .contiguous(memory_format=torch.channels_last)}
    for key in ("label", "sup", "prob"):
        if key in batch:
            m = batch[key]
            out[key] = torch.stack([
                _d4(m[i, y:y + th, x:x + tw], d4[i], draws.mode, (0, 1))
                for i, (y, x) in enumerate(draws.offsets.tolist())])
    return out


@pytest.mark.parametrize("mode", ["oneof", "compose"])
@pytest.mark.parametrize("hw", [40, 24])
def test_device_augmentation_matches_per_sample_path(mode, hw):
    """Every D4 op of both modes (oneof: none, hflip, vflip, rot90 by 0-3;
    compose: each of the 8 flip/rot combinations), on uint8 images, int32
    labels and superpixel maps and fp16 soft labels, from whole tiles at
    random origins and from host-cropped tiles: bit-equal to the per-sample
    path, with the image channels_last."""
    if mode == "oneof":
        d4 = [[0, 1, 3]] + [[1, 0, 0], [1, 1, 2]] + [[1, 2, k] for k in range(4)]
    else:
        d4 = [[h, v, r] for r in (0, 1) for v in (0, 1) for h in (0, 1)]
    b, crop = len(d4), (24, 24)
    r = np.random.default_rng(hw)
    batch = {
        "image": torch.from_numpy(r.integers(0, 256, (b, hw, hw, 3),
                                             dtype=np.uint8)),
        "label": torch.from_numpy(r.integers(-1, 6, (b, hw, hw)).astype(np.int32)),
        "sup": torch.from_numpy(r.integers(0, 40, (b, hw, hw)).astype(np.int32)),
        "prob": torch.from_numpy(r.random((b, hw, hw, 6)).astype(np.float16)),
    }
    off = torch.from_numpy(r.integers(0, hw - crop[0] + 1, (b, 2))
                           .astype(np.int32))
    draws = AugDraws(off, torch.tensor(d4, dtype=torch.int64), mode)
    got = augment_batch(batch, crop, MEAN, STD, draws, clamp=True)
    want = _per_sample(batch, crop, MEAN, STD, draws, clamp=True)
    assert got["image"].is_contiguous(memory_format=torch.channels_last)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="square"):
        augment_batch(batch, (16, 24), MEAN, STD, draws)


# ------------------------------------------- chunked steps and the CLIs


def test_chunked_steps_equal_single_steps():
    """Four stage-2 steps (resnet18, 64^2 crops of 80^2 tiles, batch 2,
    CORAL, the prototype view, the source class balance) through the loop
    at ``steps_per_call`` 2 -- step 1, a chunk of steps 2-3, step 4 -- and
    at 1 from the same start: bit-equal metrics at every step, parameters,
    momentum, prototypes and balance; every tensor of the state keeps its
    address (what a captured step needs)."""
    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.train.loop import (
        build_model,
        build_state,
        default_hparams,
    )
    from uemda_tpu_torch.train.steps import make_align_step

    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                              crop=(64, 64))
    src = synthetic_split(IsprsDA, n=4, hw=80, seed=1)
    tgt = synthetic_split(IsprsDA, n=4, hw=80, seed=2, domain_shift=10.0)
    hp = default_hparams(cfg, align_domain=True, refine_mode="p",
                         balance_source=True, compute_dtype="float32")
    proto = torch.randn(cfg.class_num, 512,
                        generator=torch.Generator().manual_seed(3))
    runs = []
    for k in (1, 2):
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        state = build_state(model, cfg, 4, prototypes=proto)
        tensors = ([state.aligner.prototypes, state.balance_s.freq,
                    state.opt.lr] + state.opt.trace + state.opt.params)
        ptrs = [t.data_ptr() for t in tensors]
        seen = []
        log, lines = _logger(f"chunk-{k}")
        run_training_loop(state, make_align_step(model, hp),
                          infinite_batches(src, 2, seed=5),
                          infinite_batches(tgt, 2, seed=6), 4, log,
                          eval_every=100, log_every=3, steps_per_call=k,
                          on_step=lambda i, m: seen.append((i, m)))
        assert [t.data_ptr() for t in [state.aligner.prototypes,
                                       state.balance_s.freq, state.opt.lr]
                + state.opt.trace + state.opt.params] == ptrs
        assert [x for x in lines if x.startswith("steps ")] == (
            ["steps 2-3 in one call"] if k == 2 else [])
        runs.append((seen, [t.clone() for t in tensors]))
    (seen1, t1), (seen2, t2) = runs
    assert [i for i, _ in seen1] == [i for i, _ in seen2] == [1, 2, 3, 4]
    for (_, a), (_, b) in zip(seen1, seen2):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(torch.equal(a, b) for a, b in zip(t1, t2))


def _tiny_config(tmp_path):
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), IsprsDA, n_train=4, n_val=1, hw=80,
                           seed=3)
    img, ann = root / "img_dir", root / "ann_dir"
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from uemda_tpu_torch.config import PRESETS, SplitConfig\n"
        f"m, s = {MEAN}, {STD}\n"
        f"tr = SplitConfig(({str(img / 'train')!r},), ({str(ann / 'train')!r},), m, s, batch_size=2)\n"
        f"va = SplitConfig(({str(img / 'val')!r},), ({str(ann / 'val')!r},), m, s, batch_size=1)\n"
        "CONFIG = dataclasses.replace(PRESETS['2vaihingen'], model='resnet18', "
        f"crop=(64, 64), source=tr, target=tr, val=va, test=va, "
        f"snapshot_dir={str(tmp_path / 'log')!r})\n")
    return str(cfg_file)


@pytest.mark.parametrize("tool,profile", [
    ("train_src", False), ("train_align_uem", False), ("train_ssl_uem", False),
    ("train_src", True)])
def test_trainer_cli_runs_the_loop_flags(tmp_path, monkeypatch, caplog, tool,
                                         profile):
    """Each trainer CLI on a tiny synthetic config (resnet18, 64^2 crops of
    80^2 tiles) with ``--host-crop 1 --steps-per-call 2 --device cpu`` and
    3 steps: step 1, then a chunk of 2 (the stage-3 one after its
    pseudo-label sweep); each ends at step 3 with its best model,
    ``best.json`` and its state snapshot. With ``--profile-dir`` a run this
    short profiles its second step and runs every step alone. Then
    ``--steps 6 --resume auto``: the run restores step 3 (stage 3 without
    a second sweep), runs steps 4-5 in one call and step 6, and leaves the
    step-6 snapshot and ``metrics.jsonl`` records of both runs."""
    import importlib
    import json

    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.train.loop import build_model

    monkeypatch.chdir(tmp_path)
    caplog.set_level(logging.DEBUG, logger=f"uemda_tpu_torch.{tool}")
    cfg_file = _tiny_config(tmp_path)
    main = importlib.import_module(f"uemda_tpu_torch.tools.{tool}").main
    argv = ["--config-path", cfg_file, "--steps", "3", "--device", "cpu",
            "--host-crop", "1", "--steps-per-call", "2"]
    if tool != "train_src":
        model = build_model(load_config(cfg_file), device="cpu",
                            generator=torch.Generator().manual_seed(0))
        torch.save(model.state_dict(), tmp_path / "m.pth")
        np.save(tmp_path / "p.npy", np.random.default_rng(0).normal(
            size=(6, 512)).astype(np.float32))
        argv += ["--ckpt-model", str(tmp_path / "m.pth"),
                 "--ckpt-proto", str(tmp_path / "p.npy")]
    if profile:
        argv += ["--profile-dir", str(tmp_path / "trace")]
    out = main(argv)
    stage = {"train_src": "src", "train_align_uem": "align",
             "train_ssl_uem": "ssl"}[tool]
    run_dir = tmp_path / "log" / stage
    assert out["step"] == 3 and (run_dir / "Vaihingen_best.pth").exists()
    assert json.loads((run_dir / "best.json").read_text())["step"] == 3
    chunks = [m for m in caplog.messages if m.endswith("in one call")]
    assert chunks == ([] if profile else ["steps 2-3 in one call"])
    assert (tmp_path / "trace" / "trace.json").exists() == profile
    snap = torch.load(run_dir / "state_curr.pth", weights_only=True)
    assert snap["step"] == snap["opt"]["count"] == 3
    if profile:
        shutil.rmtree(tmp_path / "log")  # ~0.6 GB of checkpoints
        return
    caplog.clear()
    sweeps = len(list((tmp_path / "log" / "pseudo_label").glob("*.npy")))
    main(argv[:3] + ["6"] + argv[4:] + ["--resume", "auto"])
    assert any(m.startswith("resumed full train state from") and
               m.endswith("at step 3") for m in caplog.messages)
    assert [m for m in caplog.messages if m.endswith("in one call")] == [
        "steps 4-5 in one call"]
    assert not any("generating pseudo labels" in m for m in caplog.messages)
    assert len(list((tmp_path / "log" / "pseudo_label").glob("*.npy"))) \
        == sweeps
    snap = torch.load(run_dir / "state_curr.pth", weights_only=True)
    assert snap["step"] == snap["opt"]["count"] == 6
    recs = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], "miou" in r) for r in recs] == [
        (1, False), (3, True), (6, True)]
    shutil.rmtree(tmp_path / "log")

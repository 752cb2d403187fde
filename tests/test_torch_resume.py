"""The trainers' state on disk in the port, on the CPU: atomic checkpoint
writes and the run-dir lock (twins of ``tests/test_run_lock.py``), the
loop's deadline, ``TrainState.state_dict`` round trips, the loop's records
(``iter=``/``eval@`` lines, ``metrics.jsonl``, ``best.json``, snapshots)
against JAX's ``run_training_loop`` and ``maybe_resume`` on a toy step,
interrupted and resumed, and exact resume of stage-2, stage-3 and combo
mix steps. The snapshot of a captured step is tested on the card
(test_torch_gpu.py)."""

import dataclasses
import itertools
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from uemda_tpu.train import checkpoints as jax_ckpt
from uemda_tpu.train import loop as jax_loop
from uemda_tpu_torch.config import PRESETS
from uemda_tpu_torch.datasets.base import ArrayDataset, infinite_batches
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.synthetic import synthetic_split
from uemda_tpu_torch.train import checkpoints
from uemda_tpu_torch.train.checkpoints import (
    AsyncSaver,
    RunDirLock,
    load_checkpoint,
    save_checkpoint,
)
from uemda_tpu_torch.train.loop import (
    _deadline,
    build_model,
    build_state,
    default_hparams,
    maybe_resume,
    run_training_loop,
)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# ------------------------------------------------- writes and the lock


def test_save_checkpoint_concurrent_same_path(tmp_path):
    """8 threads writing one path 20 times each: no error, no partial
    file, no tmp left; the survivor is one writer's whole payload."""
    path = str(tmp_path / "ckpt.pth")
    payloads = [torch.full((64,), float(t)) for t in range(8)]
    errs = []

    def writer(t):
        try:
            for _ in range(20):
                save_checkpoint(path, payloads[t])
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    got = load_checkpoint(path)
    assert any(torch.equal(got, p) for p in payloads)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_run_lock_blocks_second_acquire(tmp_path):
    lock = RunDirLock(str(tmp_path)).acquire()
    with pytest.raises(RuntimeError, match="locked by live pid"):
        RunDirLock(str(tmp_path)).acquire()
    lock.release()
    with RunDirLock(str(tmp_path)):
        assert (tmp_path / ".run_lock").read_text() == str(os.getpid())
    assert not (tmp_path / ".run_lock").exists()


def test_run_lock_steals_stale_lock(tmp_path):
    """A lock whose holder is dead is stolen: a crashed run resumes
    without a manual cleanup."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    (tmp_path / ".run_lock").write_text(str(proc.pid))
    try:
        os.kill(proc.pid, 0)
        pytest.skip("pid unexpectedly alive (reused)")
    except ProcessLookupError:
        pass
    lock = RunDirLock(str(tmp_path)).acquire()
    assert (tmp_path / ".run_lock").read_text() == str(os.getpid())
    lock.release()


def test_run_lock_steals_garbled_lock(tmp_path):
    (tmp_path / ".run_lock").write_text("not-a-pid")
    RunDirLock(str(tmp_path)).acquire().release()
    assert not (tmp_path / ".run_lock").exists()


def test_training_loop_refuses_locked_run_dir(tmp_path):
    """The loop fails fast when a live process holds its run dir, before
    it touches the state, the iterators or the device."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    held = RunDirLock(str(run_dir)).acquire()
    with pytest.raises(RuntimeError, match="locked by live pid"):
        run_training_loop(None, None, None, None, 1, logging.getLogger("t"),
                          state_path=str(run_dir / "state_curr.pth"))
    held.release()


@pytest.mark.parametrize("fn,timeout,outcome", [
    (lambda: 42, 5.0, 42),
    (lambda: 42, 0, 42),
    (lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0, ValueError),
    (lambda: time.sleep(30), 0.2, TimeoutError),
])
def test_deadline(fn, timeout, outcome):
    """``_deadline`` returns the result (0: on the caller's thread),
    raises the worker's error, and raises ``TimeoutError`` naming
    ``--resume auto`` on a hang; as ``tests/test_train_steps.py``'s."""
    for deadline in (_deadline, jax_loop._deadline):
        if isinstance(outcome, type):
            with pytest.raises(outcome, match="boom|resume auto"):
                deadline(fn, timeout, "what")
        else:
            assert deadline(fn, timeout, "what") == outcome


def test_async_saver_writes_what_was_saved_and_raises_later(tmp_path):
    """The saver's file holds the tensors as they were at ``save`` (a
    later in-place update does not leak into it); a write error comes out
    of the next ``wait``."""
    t = torch.arange(6.0)
    saver = AsyncSaver()
    saver.save(str(tmp_path / "a.pth"), {"t": t, "n": 3})
    t.add_(100)  # the step after the snapshot
    saver.wait()
    got = load_checkpoint(str(tmp_path / "a.pth"))
    assert got["n"] == 3 and torch.equal(got["t"], torch.arange(6.0))
    assert saver.nbytes == 24 and saver.write_s > 0
    (tmp_path / "file").write_text("")
    saver.save(str(tmp_path / "file" / "b.pth"), {"t": t})  # fails there
    with pytest.raises(OSError):
        saver.wait()
    saver.close()
    assert not saver._t.is_alive()


# -------------------------------------------------------- the state dict


def _state(seed=0, cfg=None):
    cfg = cfg or dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                                     crop=(64, 64))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    proto = torch.randn(cfg.class_num, 512,
                        generator=torch.Generator().manual_seed(3))
    return build_state(model, cfg, 6, prototypes=proto)


def _tensors(state):
    sd = state.state_dict()
    return ([sd["model"][k] for k in sorted(sd["model"])] + sd["opt"]["trace"]
            + [sd["aligner"][k] for k in sorted(sd["aligner"])]
            + [sd["balance_s"]["freq"], sd["balance_t"]["freq"]])


def test_state_dict_round_trip_is_exact_and_in_place(tmp_path):
    """A state with every part moved off its start (masters, BatchNorm
    buffers, momentum, count, step, prototypes, sums, both balances)
    through ``save_checkpoint`` and ``load_checkpoint`` into a fresh
    state: every tensor bit-equal, and every tensor of the fresh state at
    the address it had (a captured step reads fixed addresses)."""
    a = _state(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in _tensors(a):
            if t.is_floating_point():
                t.add_(torch.randn(t.shape, generator=g))
            else:
                t.add_(3)
    a.step, a.opt.count = 17, 17
    save_checkpoint(str(tmp_path / "s.pth"), a.state_dict())
    b = _state(1)
    ptrs = [t.data_ptr() for t in _tensors(b)]
    b.load_state_dict(load_checkpoint(str(tmp_path / "s.pth")))
    assert b.step == b.opt.count == 17
    assert [t.data_ptr() for t in _tensors(b)] == ptrs
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


def test_state_dict_refuses_a_mismatch_by_name():
    """A wrong shape, a wrong dtype or a missing key raises with its name,
    and nothing is written."""
    a, b = _state(0), _state(1)
    before = [t.clone() for t in _tensors(b)]
    sd = a.state_dict()
    bad = dict(sd, aligner=dict(sd["aligner"],
                                prototypes=torch.zeros(6, 256)))
    with pytest.raises(ValueError, match="aligner.prototypes is \\(6, 256\\)"):
        b.load_state_dict(bad)
    key = next(iter(sd["model"]))
    bad = dict(sd, model=dict(sd["model"], **{key: sd["model"][key].double()}))
    with pytest.raises(ValueError, match=f"model.{key} "):
        b.load_state_dict(bad)
    bad = dict(sd, balance_t={})
    with pytest.raises(KeyError, match="balance_t.'freq'"):
        b.load_state_dict(bad)
    bad = dict(sd, opt={"trace": sd["opt"]["trace"]})
    with pytest.raises(KeyError, match="opt.'count'"):
        b.load_state_dict(bad)
    assert all(torch.equal(x, y) for x, y in zip(before, _tensors(b)))


# ------------------------------------- the loop's records against JAX's


class _JaxToy(NamedTuple):
    params: jnp.ndarray
    step: jnp.ndarray


@jax.jit
def _jax_toy_step(state, bs, bt, key):
    del key
    s = state.step + 1
    return (_JaxToy(state.params + bs["x"].sum(), s),
            {"count": s.astype(jnp.float32), "x": bs["x"].sum() + bt["x"].sum()})


@dataclasses.dataclass
class _TorchToy:
    step: int
    model: torch.nn.Module
    params: torch.Tensor

    def state_dict(self):
        return {"step": self.step, "params": self.params}

    def load_state_dict(self, sd):
        self.params.copy_(sd["params"])
        self.step = sd["step"]


def _torch_toy_step(state, bs, bt, seed):
    state.params += bs["x"].sum()
    state.step += 1
    return {"count": torch.tensor(float(state.step)),
            "x": bs["x"].sum() + bt["x"].sum()}


def _stream(skip=0, crash_at=None):
    """Batch i is {'x': [i % 7]}; batch ``crash_at`` raises (a crash)."""
    for i in itertools.count(skip):
        if i == crash_at:
            raise OSError("crash")
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


def _miou(step):
    """An mIoU that peaks at step 7: a resumed run must not let step 14
    overwrite that best (best.json)."""
    return ((int(step) * 37) % 10) / 10


def distinct(steps):
    """Snapshot steps without a repeat of the one before: the JAX loop's
    final save rewrites the snapshot its last evaluation took of the same
    step, the port's does not."""
    return [s for i, s in enumerate(steps) if i == 0 or s != steps[i - 1]]


class _SyncSaver:
    """JAX's AsyncSaver writing at once, so its snapshot is on disk when
    the loop dies."""

    def save(self, path, state):
        jax_ckpt.save_checkpoint(path, jax.tree.map(np.asarray, state))

    def wait(self):
        pass


@pytest.mark.parametrize("k", [1, 3])
def test_loop_records_and_resume_match_jax(tmp_path, monkeypatch, k):
    """The port's ``run_training_loop`` + ``maybe_resume`` and JAX's on a
    toy counter step, 23 steps, logs every 5, evaluations every 7, K = k:
    once uninterrupted, and once killed when step 10's batch is read (the
    last snapshot is step 7's), then resumed with ``--resume auto`` and
    streams skipped to the snapshot's step. Both give the same ``iter=``
    and ``eval@`` lines, the same ``metrics.jsonl`` records (steps, keys,
    values), the same ``best.json`` and snapshots at the same steps
    (``distinct``); the interrupted run's records equal the uninterrupted
    one's and its final state too. A fresh start clears the stale
    records."""
    snaps = {"jax": [], "port": []}
    save_j, save_t = jax_ckpt.save_checkpoint, checkpoints.save_checkpoint

    def rec_j(path, state):
        snaps["jax"].append(int(state.step))
        return save_j(path, state)

    def rec_t(path, obj):
        snaps["port"].append(int(obj["step"]))
        return save_t(path, obj)

    monkeypatch.setattr(jax_ckpt, "save_checkpoint", rec_j)
    monkeypatch.setattr(jax_loop, "save_checkpoint", rec_j)
    monkeypatch.setattr(jax_ckpt, "AsyncSaver", _SyncSaver)
    monkeypatch.setattr(checkpoints, "save_checkpoint", rec_t)
    out = {}
    for name in ("jax", "port"):
        for crash in (None, 9):
            run = tmp_path / f"{name}-{crash}"
            run.mkdir()
            path = str(run / ("state_curr.msgpack" if name == "jax"
                              else "state_curr.pth"))
            log, lines = _logger(f"{name}-{crash}-{k}")
            snaps[name].clear()
            for resume in ("", "auto") if crash else ("",):
                if name == "jax":
                    state = _JaxToy(jnp.zeros((), jnp.float32),
                                    jnp.zeros((), jnp.int32))
                    state, start, p = jax_loop.maybe_resume(state, str(run),
                                                            resume, log)
                    hooks = jax_loop.LoopHooks(
                        eval_every=7, log_every=5, steps_per_call=k,
                        eval_fn=lambda s: _miou(s.step), state_path=path)
                    go = lambda: jax_loop.run_training_loop(  # noqa: E731
                        state, _jax_toy_step,
                        _stream(start, crash if not resume else None),
                        _stream(start), 23, log, hooks, start_step=start)
                else:
                    state = _TorchToy(0, torch.nn.Linear(1, 1),
                                      torch.zeros(()))
                    state, start, p = maybe_resume(state, str(run), resume,
                                                   log)
                    go = lambda: run_training_loop(  # noqa: E731
                        state, _torch_toy_step,
                        _stream(start, crash if not resume else None),
                        _stream(start), 23, log, eval_every=7, log_every=5,
                        eval_fn=lambda s: _miou(s.step), steps_per_call=k,
                        state_path=p)
                assert p == path and start == (7 if resume else 0)
                if crash and not resume:
                    with pytest.raises(OSError, match="crash"):
                        go()
                else:
                    final = go()
            params = float(final.params if name == "jax"
                           else state.params)
            out[name, crash] = dict(
                lines=[x for x in lines if x.startswith(("iter=", "eval@"))],
                jsonl=(run / "metrics.jsonl").read_text().splitlines(),
                best=(run / "best.json").read_text(),
                snaps=list(snaps[name]), params=params)
    for crash in (None, 9):
        jax_run = out["jax", crash]
        assert out["port", crash] == dict(
            jax_run, snaps=distinct(jax_run["snaps"])), crash
    a, b = out["port", None], out["port", 9]
    assert a["jsonl"] == b["jsonl"] and a["params"] == b["params"]
    assert a["snaps"] == b["snaps"] == [7, 14, 21, 23]
    assert [x for x in b["lines"] if x.startswith("eval@")][1] == (
        "eval@14: mIoU=0.80000 (best 0.90000 @ iter 7)")
    run = tmp_path / "port-9"
    maybe_resume(None, str(run), "", logging.getLogger("t"))
    assert not (run / "best.json").exists()
    assert not (run / "metrics.jsonl").exists()


# ------------------------------------------- exact resume of real steps


def _stage(stage, cfg):
    from uemda_tpu_torch.train.steps import (
        make_align_step,
        make_mix_step,
        make_ssl_step,
    )

    if stage == "align":
        hp = default_hparams(cfg, align_domain=True, refine_mode="p",
                             balance_source=True, compute_dtype="float32")
        return lambda m: make_align_step(m, hp)
    hp = default_hparams(cfg, refine_mode="all", balance_target=True,
                         max_segments=64, compute_dtype="float32")
    if stage == "ssl":
        return lambda m: make_ssl_step(m, hp)
    return lambda m: make_mix_step(m, hp, mix="classmix", combo=True)


@pytest.mark.parametrize("stage", ["align", "ssl", "mix"])
def test_resume_is_exact(tmp_path, stage):
    """Four steps of stage 2 (CORAL, the prototype view, the source class
    balance), stage 3 (UVEM, refine 'all', the target class balance) or
    the combo mix step (ClassMix, UVEM, refine 'all'), resnet18, 64^2
    crops of 80^2 tiles, batch 2: uninterrupted, and, at K = 1 and at
    K = 2 (stage 3 and the mix step: K = 2, which resumes into the chunk
    rule), as two steps with a snapshot, ``maybe_resume`` into a freshly
    built state and two more on streams skipped by two. Bit-equal: the
    metrics of steps 3-4, every tensor of the state, the step and the
    update count."""
    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                              crop=(64, 64))
    src = synthetic_split(IsprsDA, n=4, hw=80, seed=1)
    tgt = synthetic_split(IsprsDA, n=4, hw=80, seed=2, domain_shift=10.0,
                          with_sup=True)
    tgt = ArrayDataset(IsprsDA, tgt.images, sup=tgt.sup, prob=np.random.default_rng(
        0).dirichlet(np.full(6, 0.3), (4, 80, 80)).astype(np.float16))
    make = _stage(stage, cfg)

    def run(steps, k, run_dir, skip=0, resume="", state_path=False):
        state = _state(0, cfg)
        state, start, path = maybe_resume(state, str(run_dir), resume,
                                          logging.getLogger("t"))
        assert start == skip
        seen = []
        run_training_loop(state, make(state.model),
                          infinite_batches(src, 2, seed=5, skip_batches=start),
                          infinite_batches(tgt, 2, seed=6, skip_batches=start),
                          steps, logging.getLogger("t"), eval_every=100,
                          log_every=100, steps_per_call=k,
                          on_step=lambda i, m: seen.append((i, m)),
                          state_path=path if state_path else None)
        return state, seen

    full, seen_full = run(4, 1, tmp_path)
    for k in (1, 2) if stage == "align" else (2,):
        run_dir = tmp_path / f"k{k}"
        run(2, k, run_dir, state_path=True)
        assert (run_dir / "state_curr.pth").exists()
        resumed, seen = run(4, k, run_dir, skip=2, resume="auto",
                            state_path=True)
        assert resumed.step == resumed.opt.count == full.step == 4
        assert [i for i, _ in seen] == [3, 4]
        for (_, a), (_, b) in zip(seen, seen_full[2:]):
            assert all(torch.equal(a[n], b[n]) for n in a)
        assert all(torch.equal(x, y) for x, y in zip(_tensors(resumed),
                                                      _tensors(full)))
        shutil.rmtree(run_dir)  # ~0.3 GB a snapshot

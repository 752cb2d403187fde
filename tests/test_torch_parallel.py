"""Data parallelism of the port (``uemda_tpu_torch/parallel/``) on the CPU:
one launch of two gloo ranks (``tests/torch_parallel_worker.py``) runs
every case of ``tests/torch_parallel_cases.py`` -- the train steps of
stages 1-3, the mix step, G + D, DCA, stage 3 with OHEM and GHM,
``init_prototypes``, every audited batch reduction of the loss and
alignment modules, a loop that evaluates and snapshots, and two stage-3
steps on the JAX test's weights and draws -- while this process runs the
same cases at one rank on the global batch (resnet18, 64^2 crops, global
batch 4, 2 steps, one torch thread). The 2-rank results are held to the
1-rank ones (losses 1e-4 relative, the parameters' fingerprint rtol 1e-4,
the JAX multihost test's bound, and the BatchNorm buffers within 1e-4),
and the stage-3 steps to the JAX step on a 2-device CPU mesh."""

import filecmp
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_parallel_cases as cases
from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TIMEOUT_S = 400


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_inputs():
    """The JAX stage-3 test's weights, prototypes, batches and draws at a
    global batch of 4 (``test_torch_ssl_step.py``)."""
    import jax

    from tests.test_torch_ssl_step import CROP, HP, HW, K, _batches
    from tests.torch_port_helpers import jax_aug_draws, models_from_port

    jmodel, variables, tmodel = models_from_port("resnet18", seed=1)
    proto = np.random.default_rng(3).normal(size=(cases.C, K)).astype(
        np.float32)
    batches, draws, keys = [], [], []
    for i in range(2):
        img, label, tgt, sup, prob = _batches(i, b=cases.GB)
        batches.append(({"image": img, "label": label},
                        {"image": tgt, "sup": sup, "prob": prob}))
        key = jax.random.key(i)
        k_s, k_t = jax.random.split(key, 4)[:2]
        ds = jax_aug_draws(k_s, cases.GB, (HW, HW), (CROP, CROP))
        dt = jax_aug_draws(k_t, cases.GB, (HW, HW), (CROP, CROP), "compose")
        draws.append([(ds.offsets, ds.d4, "oneof"),
                      (dt.offsets, dt.d4, "compose")])
        keys.append(key)
    bundle = {"state_dict": tmodel.state_dict(), "proto": proto, "hp": HP,
              "batches": batches, "draws": draws}
    return bundle, (jmodel, variables, tmodel, proto, keys)


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The 2-rank launch, with the 1-rank reference computed here while
    the ranks run; a hung rank fails the test after ``TIMEOUT_S``."""
    out = str(tmp_path_factory.mktemp("parallel"))
    bundle, jax_side = _jax_inputs()
    torch.save(bundle, os.path.join(out, "jax_bundle.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), "2", str(r), out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for r in range(2)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {name: cases.run_step_case(name) for name in cases.STEP_CASES}
        ref["audit"] = cases.run_audit()
        os.makedirs(os.path.join(out, "ref"))
        ref["rundir"] = cases.run_rundir_case(os.path.join(out, "ref"))
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
        raise AssertionError(f"a rank hung ({TIMEOUT_S} s):\n"
                             + "\n---\n".join(o or "" for o in outs))
    finally:
        torch.set_num_threads(n)
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
        assert "RESULT rank=" in o, o

    def load(name):
        return [torch.load(os.path.join(out, f"{name}_r{r}.pt"),
                           weights_only=False) for r in range(2)]

    yield {"ref": ref, "load": load, "out": out, "jax": jax_side}
    shutil.rmtree(out, ignore_errors=True)   # the loop's snapshots


def _close_states(got: dict, want: dict, what: str) -> None:
    """Each tensor within 1e-4 of its largest entry (integers equal)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            assert torch.equal(g, w), f"{what} {k}"
            continue
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g.double() - w.double()).abs().max()) if w.numel() else 0
        assert err <= 1e-4 * scale + 1e-12, f"{what} {k}: {err} > 1e-4 x {scale}"


def _sq_norm(a: dict, b: dict) -> float:
    """An estimate of ||a - b||^2 over the sketched tensors: each tensor's
    sampled squared differences scaled to its size."""
    total = 0.0
    for k, (va, n) in a.items():
        d = (va.double() - b[k][0].double()) ** 2
        total += float(d.sum()) * n / va.numel()
    return total


def _params_close(got: dict, want: dict, start: dict, what: str,
                  prefix: str = "model.", bound: float = 1e-2) -> None:
    """Parameters (``torch_parallel_cases.sketch``): the fingerprint (the
    sum of every |p|) within rtol 1e-4, the JAX multihost test's bound,
    and the 2-rank update within 1% of the 1-rank update's norm. Tighter
    is not to be had at this size: a 1e-6 change of the input moves this
    resnet18's gradients by more than 1e-3 of their norm (a batch of 4
    through BatchNorm at 64^2), and the two runs sum in other orders."""
    np.testing.assert_allclose(got["fp"], want["fp"], rtol=1e-4,
                               err_msg=what)
    assert set(got["sample"]) == set(want["sample"]), what

    def part(d):
        return {k: v for k, v in d["sample"].items() if k.startswith(prefix)}

    num = _sq_norm(part(got), part(want))
    den = _sq_norm(part(want), part(start))
    assert den > 0 and (num / den) ** 0.5 < bound, (what, (num / den) ** 0.5)


@pytest.mark.parametrize("name", list(cases.STEP_CASES))
def test_two_ranks_equal_one_rank_at_the_global_batch(launch, name):
    """Each step at 2 gloo ranks (each on its rows of the global batch,
    the draws made for the global batch) against 1 rank at the global
    batch: both ranks report the same metrics, within 1e-4 relative of the
    1-rank step's, and hold the same state, bit for bit; the BatchNorm
    running buffers, prototypes, class balances and GHM histogram within
    1e-4 of each tensor's largest entry of the 1-rank run's, the
    parameters as ``_params_close``."""
    ref = launch["ref"][name]
    r0, r1 = launch["load"](name)
    assert r0["metrics"] == r1["metrics"]
    assert len(r0["metrics"]) == len(ref["metrics"])
    for got, want in zip(r0["metrics"], ref["metrics"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-7, err_msg=f"{name} {k}")
    # the replicas hold one state, bit for bit
    assert r0["state"]["params"]["sha"] == r1["state"]["params"]["sha"]
    for k, v in r0["state"]["buffers"].items():
        assert torch.equal(v, r1["state"]["buffers"][k]), f"{name} {k}"
    buffers = ref["state"]["buffers"]
    assert any("running" in k for k in buffers)
    _close_states(r0["state"]["buffers"], buffers, f"{name}: 2 ranks vs 1")
    if name != "init_proto":
        _params_close(r0["state"]["params"], ref["state"]["params"],
                      ref["start"], name)
    if name == "adv":
        # D's Adam makes sign-like first updates, lr x g / |g|: an element
        # whose gradient is rounding-sized flips with the summation order
        _params_close(r0["state"]["params"], ref["state"]["params"],
                      ref["start"], name, prefix="disc.", bound=5e-2)


@pytest.mark.parametrize("name", cases.audit_names())
def test_every_batch_reduction_is_global(launch, name):
    """Each audited function of the loss and alignment modules (the
    reductions of ``PERF.md``'s audit: means and counts, OHEM's sort, the
    GHM/GDP histograms, CORAL, the prototype sums, the class balance, the
    halves and top-k's over the batch, the permutations, TransNorm's
    statistics) at 2 ranks returns the 1-rank value on both ranks, and
    the gradient of each rank's rows is the 1-rank gradient's rows."""
    want = launch["ref"]["audit"][name]
    got = [r[name] for r in launch["load"]("audit")]
    if want["local"]:   # per-row results: the ranks' rows in rank order
        for i, w in enumerate(want["value"]):
            v = torch.cat([g["value"][i] for g in got])
            np.testing.assert_allclose(v.float().numpy(), w.float().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    else:
        for g in got:
            np.testing.assert_allclose(g["value"].numpy(),
                                       want["value"].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
    for k, w in want.get("grads", {}).items():
        g = torch.cat([r["grads"][k] for r in got])
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6 * max(float(w.abs().max()), 1e-3),
                                   err_msg=f"{name} d/d{k}")


def test_only_process_zero_writes_the_run_dir(launch):
    """The loop at 2 ranks, steps_per_call 2, an evaluation every 2 steps,
    snapshots: rank 0's run dir holds what the 1-rank run's holds (the
    snapshot, best.json, metrics.jsonl), rank 1's stays empty and rank 1
    never evaluates; both end on the 1-rank parameters."""
    ref = launch["ref"]["rundir"]
    r0, r1 = launch["load"]("rundir")
    assert ref["files"] == ["best.json", "metrics.jsonl", "state_curr.pth"]
    assert r0["files"] == ref["files"] and r1["files"] == []
    assert ref["evals"] == r0["evals"] == 2 and r1["evals"] == 0
    assert r0["params"]["sha"] == r1["params"]["sha"]
    np.testing.assert_allclose(r0["params"]["fp"], ref["params"]["fp"],
                               rtol=1e-4)


def test_stage3_at_two_ranks_matches_jax_on_a_two_device_mesh(launch,
                                                             monkeypatch):
    """Two stage-3 steps (UVEM, refine 'all', target class balance, the
    ISPRS clamp) at 2 gloo ranks against ``make_ssl_step`` jitted over a
    2-device CPU mesh (batch sharded, state replicated), from the same
    weights, prototypes, batches and draws, dropout off: the losses 1e-4
    relative, the prototypes within 1e-5 of their largest entry, the
    class-balance frequencies 1e-6, the updates as
    ``test_torch_ssl_step.py``'s single-device test holds them."""
    import jax

    from tests.test_torch_ssl_step import HP, _no_dropout, _states
    from uemda_tpu.parallel import make_mesh, shard_batch, \
        shard_pytree_replicated
    from uemda_tpu.train.steps import StageHParams as JaxHParams
    from uemda_tpu.train.steps import make_ssl_step as jax_make_ssl_step
    from uemda_tpu_torch.models.port import state_dict_from_jax

    _no_dropout(monkeypatch)
    jmodel, variables, tmodel, proto, keys = launch["jax"]
    jstate, _ = _states(variables, tmodel, prototypes=proto)
    mesh = make_mesh(2)
    jstate = shard_pytree_replicated(mesh, jstate)
    jstep = jax_make_ssl_step(jmodel, JaxHParams(**HP))
    bundle = torch.load(os.path.join(launch["out"], "jax_bundle.pt"),
                        weights_only=False)
    jms = []
    for (bs, bt), key in zip(bundle["batches"], keys):
        bt = dict(bt, prob=bt["prob"].astype(np.float32))
        jstate, jm = jstep(jstate, shard_batch(mesh, bs),
                           shard_batch(mesh, bt), key)
        jms.append({k: float(v) for k, v in jm.items()})
    r0, r1 = launch["load"]("jax")
    assert r0["metrics"] == r1["metrics"]
    for got, want in zip(r0["metrics"], jms):
        for k in ("loss", "loss_source", "loss_target"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    st = r0["state"]["buffers"]
    want = np.asarray(jstate.aligner.prototypes)
    np.testing.assert_allclose(st["aligner.prototypes"].numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(st["balance_t.freq"].numpy(),
                               np.asarray(jstate.balance_t.freq), rtol=1e-6)
    jsd = state_dict_from_jax({
        "params": jax.tree.map(np.asarray, jstate.params),
        "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    for k, w in jsd.items():
        if "running" in k:
            g, w = st[f"model.{k}"].double().numpy(), w.double().numpy()
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), k
    # the updates as test_torch_ssl_step.py's single-device test holds them
    start = state_dict_from_jax(variables)
    got = r0["state"]["params"]["sample"]
    keys = [k[len("model."):] for k in got]
    want = cases.sketch([(f"model.{k}", jsd[k]) for k in keys])["sample"]
    w0 = cases.sketch([(f"model.{k}", start[k]) for k in keys])["sample"]
    rel = (_sq_norm(got, want) / _sq_norm(want, w0)) ** 0.5
    assert rel < 0.15, rel


def test_local_batch_slice_and_process_shard_match_jax(monkeypatch, tmp_path):
    """``local_batch_slice`` partitions the global batch as JAX's at 4
    processes (and refuses an uneven one), and ``infinite_batches`` with
    ``process_shard`` -- host crops too -- gives the rows of JAX's sharded
    stream, which concatenate to the global stream."""
    import jax

    from uemda_tpu.datasets.base import SegDataset as JaxSegDataset
    from uemda_tpu.datasets.base import infinite_batches as jax_batches
    from uemda_tpu.datasets.meta import IsprsDA as JaxIsprsDA
    from uemda_tpu.parallel import multihost as jax_mh
    from uemda_tpu_torch.datasets.base import SegDataset, infinite_batches
    from uemda_tpu_torch.datasets.meta import IsprsDA
    from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset
    from uemda_tpu_torch.parallel import multihost

    for pid in range(4):
        monkeypatch.setattr(multihost, "process_count", lambda: 4)
        monkeypatch.setattr(multihost, "process_index", lambda p=pid: p)
        monkeypatch.setattr(jax, "process_count", lambda: 4)
        monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
        assert multihost.local_batch_slice(8) == jax_mh.local_batch_slice(8)
    with pytest.raises(AssertionError):
        multihost.local_batch_slice(9)
    img_dir, ann_dir = make_synthetic_dataset(str(tmp_path), IsprsDA,
                                              n_train=6, n_val=2, hw=32,
                                              seed=0, with_sup=False)
    ds = SegDataset(IsprsDA, [img_dir], ann_dir)
    jds = JaxSegDataset(JaxIsprsDA, [img_dir], ann_dir)
    for crop in (None, (24, 24)):
        full = infinite_batches(ds, 4, seed=5, host_crop=crop)
        halves = [infinite_batches(ds, 4, seed=5, host_crop=crop,
                                   process_shard=(s, 2)) for s in (0, 2)]
        jhalves = [jax_batches(jds, 4, seed=5, host_crop=crop,
                               process_shard=(s, 2)) for s in (0, 2)]
        for _ in range(4):
            g = next(full)
            a, b = (next(h) for h in halves)
            for k in ("image", "label"):
                np.testing.assert_array_equal(g[k], np.concatenate([a[k],
                                                                    b[k]]))
            for mine, theirs in zip((a, b), (next(h) for h in jhalves)):
                for k in ("image", "label"):
                    np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize("preset", sorted(cases.PRESETS))
def test_snapshot_config_matches_jax_byte_for_byte(preset, tmp_path):
    """``config.json`` of every preset as the JAX package writes it."""
    from uemda_tpu.config import PRESETS as JAX_PRESETS
    from uemda_tpu.config import snapshot_config as jax_snapshot
    from uemda_tpu_torch.config import PRESETS, snapshot_config

    snapshot_config(PRESETS[preset], str(tmp_path / "port"))
    jax_snapshot(JAX_PRESETS[preset], str(tmp_path / "jax"))
    assert filecmp.cmp(tmp_path / "port" / "config.json",
                       tmp_path / "jax" / "config.json", shallow=False)


def test_trainer_cli_reaches_its_steps_on_two_cpu_ranks(tmp_path, monkeypatch):
    """``train_src --num-devices 2 --device cpu --steps 2`` on the pipeline
    test's tiny config (resnet18, 64^2 crops, source batch 2): the launcher
    starts two gloo processes, each trains on its row of every batch, and
    process 0 alone writes the run dir: ``config.json`` (the JAX package's
    bytes), the snapshot at step 2, ``best.json``, ``metrics.jsonl`` and
    the checkpoints."""
    import json

    from tests.test_torch_pipeline import _tiny_config
    from uemda_tpu_torch.config import load_config, snapshot_config
    from uemda_tpu_torch.tools import train_src
    from uemda_tpu_torch.train.checkpoints import load_checkpoint

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg_file = _tiny_config(tmp_path)
    assert train_src.main(["--config-path", cfg_file, "--num-devices", "2",
                           "--device", "cpu", "--steps", "2",
                           "--align-domain", "1"]) is None
    run_dir = tmp_path / "log" / "src"
    assert {"config.json", "best.json", "metrics.jsonl", "state_curr.pth",
            "Vaihingen_best.pth", "Vaihingen_curr.pth"} <= set(
        os.listdir(run_dir))
    assert load_checkpoint(str(run_dir / "state_curr.pth"))["step"] == 2
    recs = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    snapshot_config(load_config(cfg_file, snapshot_postfix="/src"),
                    str(tmp_path / "want"))
    assert filecmp.cmp(run_dir / "config.json",
                       tmp_path / "want" / "config.json", shallow=False)
    shutil.rmtree(tmp_path / "log")   # ~0.5 GB of checkpoints


def test_a_rounding_sized_input_change_moves_the_gradients(one_cpu_thread):
    """Why ``_params_close`` bounds the 2-rank update at 1% of the 1-rank
    update and not at rtol 1e-4: at this size (resnet18, 64^2, batch 4,
    BatchNorm on batch statistics) a change of 1e-6 in the input moves
    some parameter's gradient by more than 1e-3 of its norm, so two runs
    that sum in different orders cannot agree to 1e-4."""
    from uemda_tpu_torch.alignment.losses import cross_entropy_loss

    bs, _ = cases.global_batches(10)
    x0 = torch.from_numpy(bs["image"]).permute(0, 3, 1, 2).float() / 100 - 1
    lab = torch.from_numpy(bs["label"][:, ::16, ::16][:, :5, :5].copy())
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(1))

    def grads(eps):
        model = cases._model(1).train()
        x = (x0 + eps * noise).contiguous(memory_format=torch.channels_last)
        masks = {k: torch.ones(x.shape[0], 512, 5, 5, dtype=torch.bool)
                 for k in ("layer5", "layer6")}
        p1, p2, _ = model(x, None, masks)
        (cross_entropy_loss(p1, lab) + cross_entropy_loss(p2, lab)).backward()
        return {n: p.grad for n, p in model.named_parameters()}

    a, b = grads(0.0), grads(1e-6)
    worst = max(float((b[k] - v).norm() / v.norm()) for k, v in a.items()
                if float(v.norm()) > 0)
    assert worst > 1e-3, worst

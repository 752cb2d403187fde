"""Row-sharded raster inference (``uemda_tpu_torch/infer/raster.py``), the
data-parallel evaluation and sweep, and the slide predictor's refusal of an
image smaller than its tile, on the CPU.

One launch of two gloo ranks (``tests/torch_parallel_worker.py serving``)
runs the raster predictor on batch-invariant stub rasters and, with a
seeded resnet18 (standard and fast path, TTA on and off, f32), on one raw
raster; an evaluation of a 5-image split sharded over the ranks; and the
pseudo-label sweep. This process computes the single-rank references
meanwhile. The stub rasters are held bit for bit to ``make_predictor``
over the padded raster; the resnet18 rasters to it and to JAX's
``raster_predict`` on a 2-device mesh within 1e-6 (CPU convolutions round
differently with the batch a window runs in, so a real model's windows
are not bit-stable across batchings)."""

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TIMEOUT_S = 300
PLANS = [((6000, 6000), (512, 512), 0.5, 8), ((90, 52), (16, 16), 0.5, 2),
         ((110, 40), (16, 16), 0.25, 2), ((1024, 1536), (512, 512), 0.5, 1),
         ((40, 23), (16, 16), 0.5, 4)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _padded_predictor(net, plan, raster, tta, tile):
    """``make_predictor`` over the zero-padded raster, cropped back."""
    from uemda_tpu_torch.infer.slide import make_predictor

    h, w = raster.shape[1:]
    padded = torch.zeros((1, 3, plan.hp, plan.wp))
    padded[0, :, :h, :w] = raster
    probs = make_predictor(net, tile, (plan.hp, plan.wp), tta=tta,
                           overlap=1 - plan.stride / plan.th,
                           compute_dtype=torch.float32, capture=False)(padded)
    return probs[0, :, :h, :w]


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """The 2-rank launch and the 1-rank references; a hung rank fails the
    test after ``TIMEOUT_S``."""
    from tests.torch_port_helpers import models_from_port
    from uemda_tpu_torch.datasets.meta import IsprsDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.infer.evaluate import evaluate_dataset
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
    from uemda_tpu_torch.infer.raster import RasterPlan

    out = str(tmp_path_factory.mktemp("raster"))
    jmodel, variables, tmodel = models_from_port("resnet18", seed=3)
    split = synthetic_split(IsprsDA, 5, 48, seed=4)
    path = os.path.join(out, "serving_bundle.pt")
    torch.save({"state_dict": tmodel.state_dict(), "images": split.images,
                "labels": split.labels}, path)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), "2", str(r), out, "serving"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for r in range(2)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {}
        for i, (hw, overlap, tta) in enumerate(cases.STUB_RASTERS):
            plan = RasterPlan(hw, (16, 16), overlap, 2)
            ref[f"stub{i}"] = _padded_predictor(
                cases.Stub(), plan, cases.stub_raster(hw), tta, (16, 16))
        raw = torch.from_numpy(cases.real_raster()).permute(2, 0, 1)
        norm = (raw - torch.tensor(cases.MEAN)[:, None, None]) \
            / torch.tensor(cases.STD)[:, None, None]
        plan = RasterPlan(cases.RASTER_HW, (32, 32), 0.5, 2)
        for fast in (False, True):
            net = cases.serving_model(path, fast)
            for tta in (False, True):
                ref[f"real_fast{int(fast)}_tta{int(tta)}"] = \
                    _padded_predictor(net, plan, norm, tta, (32, 32))
        model = cases.serving_model(path)
        summary, _ = evaluate_dataset(model, split, cases.MEAN, cases.STD,
                                      tile=(32, 32), batch_size=1,
                                      compute_dtype=torch.float32,
                                      device="cpu")
        ref["cm"] = summary["confusion_matrix"]
        generate_pseudo_labels(model, split, cases.MEAN, cases.STD,
                               out_dir=os.path.join(out, "sweep_1"),
                               tile=(32, 32), batch_size=2,
                               keep_in_memory=False,
                               compute_dtype=torch.float32, device="cpu")
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
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
    got = [torch.load(os.path.join(out, f"serving_r{r}.pt"),
                      weights_only=False) for r in range(2)]
    yield {"ref": ref, "got": got, "out": out, "path": path,
           "jax": (jmodel, variables)}
    shutil.rmtree(out, ignore_errors=True)


@pytest.mark.parametrize("args", PLANS)
def test_raster_plan_matches_jax(args):
    """The port's ``RasterPlan`` is the JAX package's geometry."""
    from uemda_tpu.infer.raster import RasterPlan as JaxPlan
    from uemda_tpu_torch.infer.raster import RasterPlan

    mine, theirs = RasterPlan(*args), JaxPlan(*args)
    for k in ("h", "w", "th", "tw", "stride", "halo", "band_h", "hp", "wp",
              "local_ys", "xs"):
        assert getattr(mine, k) == getattr(theirs, k), k
    assert mine.hp >= mine.h + mine.halo


@pytest.mark.parametrize("i", range(len(cases.STUB_RASTERS)))
def test_two_rank_raster_is_bit_equal_to_the_padded_predictor(serving, i):
    """With a model whose windows do not depend on their batch, the raster
    at 2 ranks (halo rows and the tail canvas over gloo point-to-point)
    equals ``make_predictor`` over the padded raster bit for bit, on both
    ranks: overlap 0.5 and 0.25, TTA on and off."""
    want = serving["ref"][f"stub{i}"]
    for got in serving["got"]:
        assert torch.equal(got[f"stub{i}"], want)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("tta", [False, True])
def test_two_rank_raster_matches_the_padded_predictor_and_jax(serving, fast,
                                                            tta):
    """resnet18 in f32 (the fast path: the folded model and its plain
    K2/K3/K4 versions): the 2-rank raster's probabilities within 1e-6 of
    ``make_predictor`` over the padded raster, and within 1e-6 of JAX's
    ``raster_predict`` on a 2-device mesh (the standard model with TTA:
    one XLA compile)."""
    key = f"real_fast{int(fast)}_tta{int(tta)}"
    r0, r1 = (g[key] for g in serving["got"])
    assert torch.equal(r0, r1)
    np.testing.assert_allclose(r0.numpy(), serving["ref"][key].numpy(),
                               rtol=0, atol=1e-6)
    if fast or not tta:
        return
    from uemda_tpu.infer.raster import raster_predict
    from uemda_tpu.parallel import make_mesh

    jmodel, variables = serving["jax"]
    want = np.asarray(raster_predict(
        jmodel, variables, cases.real_raster(), cases.MEAN, cases.STD,
        make_mesh(2), tile=(32, 32), tta=True, compute_dtype="float32",
        return_probs=True))
    np.testing.assert_allclose(r0.permute(1, 2, 0).numpy(), want, rtol=0,
                               atol=1e-6)


def test_evaluation_at_two_ranks_equals_one_rank(serving):
    """``evaluate_dataset(data_parallel=True)``: each rank evaluates its
    share of the 5 images; the summed confusion matrix is the 1-rank one
    on both ranks."""
    for got in serving["got"]:
        assert got["cm"] == serving["ref"]["cm"]
    assert sum(map(sum, serving["ref"]["cm"])) > 0


def test_sweep_at_two_ranks_writes_the_files_of_one_rank(serving):
    """The sweep at 2 ranks: process 0 writes every soft label (the files
    of the 1-rank sweep, byte for byte), the other rank waits at the
    barrier and both return."""
    one = os.path.join(serving["out"], "sweep_1")
    two = os.path.join(serving["out"], "sweep_2")
    names = sorted(os.listdir(one))
    assert len(names) == 5 and sorted(os.listdir(two)) == names
    for name in names:
        assert filecmp.cmp(os.path.join(one, name), os.path.join(two, name),
                           shallow=False)
    assert all(g["sweep_returned"] == [] for g in serving["got"])


@pytest.mark.parametrize("hw,tta", [((40, 100), False), ((48, 40), True)])
def test_image_smaller_than_the_tile_raises(hw, tta):
    """An image smaller than the 64^2 tile in either side: the port's
    ``make_predictor`` raises ``ValueError`` naming both sizes, with TTA
    and without, where JAX's raises ``TypeError`` (``dynamic_slice``
    cannot cut the window) -- ROADMAP C1's inputs, resnet18."""
    import jax.numpy as jnp

    from tests.torch_port_helpers import models_from_port
    from uemda_tpu.infer.slide import make_predictor as jax_make_predictor
    from uemda_tpu_torch.infer.slide import make_predictor

    jmodel, variables, tmodel = models_from_port("resnet18", seed=3)
    x = np.random.default_rng(0).normal(size=(1,) + hw + (3,)).astype(
        np.float32)
    with pytest.raises(TypeError):
        jax_make_predictor(jmodel, (64, 64), hw, tta=tta,
                           compute_dtype="float32")(variables, jnp.asarray(x))
    with pytest.raises(ValueError, match=rf"\({hw[0]}, {hw[1]}\).*\(64, 64\)"):
        make_predictor(tmodel, (64, 64), hw, tta=tta,
                       compute_dtype=torch.float32, capture=False)

"""A CPU rehearsal of every traffic driver, end to end at a tiny size with
the program's plain kernels, and the faults each cell can have: the run
comes out correct in f32, every fault planted under the timed path makes
``correct`` false, and no device metric is written from a CPU run.
``run.py`` itself refuses to run without a card."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_helpers import ROOT, one_thread, tiny_context
from benchmark.harness.spec import Spec, driver

sys.path.insert(0, os.path.join(ROOT, "benchmark"))
from run import result_line  # noqa: E402

CELLS = ["urban.ssl_uem", "vaihingen.src", "urban.sweep_tta",
         "vaihingen.single_fast_tta"]


def drive(cell: str, trace: bool = False) -> dict:
    one_thread()
    ctx = tiny_context(cell, dtype="float32")
    result = driver(ctx.traffic["driver"]).run(ctx)
    spec = Spec()
    return result_line(spec, cell, result, trace,
                       spec.limits(cell)["numbers"], None)


@pytest.mark.parametrize("cell", CELLS)
def test_each_driver_runs_on_the_cpu(cell):
    line = drive(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "checks"]
    assert line["metrics"] == {}            # nothing off the card
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(Spec().limits(cell)["numbers"])


def _half_batch(monkeypatch):
    from uemda_tpu_torch.train import steps

    for cls in (steps.SslStep, steps.SrcStep):
        orig = cls.losses

        def losses(self, state, bs, bt, params, draws, _orig=orig):
            n = bs["image"].shape[0] // 2
            cut = lambda d: d and {k: v[:n] for k, v in d.items()}  # noqa
            draws = dataclasses.replace(draws, drop_s=cut(draws.drop_s),
                                        drop_t=cut(draws.drop_t))
            return _orig(self, state, cut(bs), cut(bt), params, draws)

        monkeypatch.setattr(cls, "losses", losses)


def _unchanged(monkeypatch):
    from uemda_tpu_torch.train.optim import SGD

    monkeypatch.setattr(SGD, "update", lambda self: torch.zeros(()))


def _altered(monkeypatch):
    """Each served answer altered where the predictor produces it: the
    probabilities turned around, so every argmax is the least likely
    class and every probability is another's."""
    from uemda_tpu_torch.infer import evaluate, slide

    orig = slide.make_predictor

    def make_predictor(*args, epilogue=None, **kw):
        def turned(probs):
            probs = probs.flip(1)
            return probs if epilogue is None else epilogue(probs)
        return orig(*args, epilogue=turned, **kw)

    for module in (slide, evaluate):   # each caller's name for it
        monkeypatch.setattr(module, "make_predictor", make_predictor)


@pytest.mark.parametrize("cell,fault", [
    ("urban.ssl_uem", _unchanged), ("urban.ssl_uem", _half_batch),
    ("vaihingen.src", _unchanged), ("vaihingen.src", _half_batch),
    ("urban.sweep_tta", _altered), ("vaihingen.single_fast_tta", _altered)])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    line = drive(cell)
    assert not line["correct"], line["checks"]


def test_run_prints_no_result_without_a_card_or_the_program(tmp_path):
    bare = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    for cwd in (ROOT, str(bare)):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "urban.sweep_tta", "--seed", "1", "--seconds", "1"],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert p.returncode != 0 and p.stdout == ""

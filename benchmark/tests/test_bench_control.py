"""On the card, at each cell's own size: the program's run is correct, and
its control (the reference computed in fp8 in the program's place) and,
for a training cell, the half-batch fault (the reference's step on half of
each batch, the mean taken over it) come out not correct against the
cell's limits. ``benchmark/calibrate.py`` reads the same over a dozen
seeds; this keeps one seed a cell. Run on the card with

    python3 -m pytest --noconftest -p no:cacheprovider benchmark/tests -m gpu
"""

import time

import pytest
import torch

import bench_helpers  # noqa: F401  (puts the checkout on the path)
from benchmark.drivers.common import Context, free_device
from benchmark.harness.judge import verdict
from benchmark.harness.spec import Spec, driver

CELLS = ["urban.ssl_uem", "vaihingen.src", "urban.sweep_tta",
         "vaihingen.single_fast_tta"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from uemda_tpu_torch import kernels

    kernels.build()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_are_not_correct(card, cell):
    spec = Spec()
    entry = spec.cell(cell)
    limits = spec.limits(cell)["numbers"]
    ctx = Context(cell=cell, config=spec.config(entry["config"]),
                  traffic=spec.traffic(entry["traffic"]),
                  seed=5100000000 + CELLS.index(cell), seconds=2.0,
                  trace=False, t_start=time.perf_counter(), calibrate=True)
    res = driver(ctx.traffic["driver"]).run(ctx)
    free_device()
    assert verdict(res["readings"], limits)[0], res["readings"]
    assert not verdict(res["extra"]["control"], limits)[0]
    if "half_batch" in res["extra"]:
        assert not verdict(res["extra"]["half_batch"], limits)[0]

"""Tiny configurations of the benchmark's cells for the CPU tests: the
same files and drivers, ResNet-18 and tiles of 64 or 128 pixels, the
program's plain kernels."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.drivers.common import Context  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402

TINY_CONFIG = {"arch": "resnet18"}
TINY = {
    "urban.ssl_uem": ({"tile": 128, "crop": 64, "batch": 4},
                      {"pool": 4, "steps_per_call": 2, "warm_chunks": 1}),
    "vaihingen.src": ({"tile": 64, "crop": 64, "batch": 4},
                      {"pool": 4, "steps_per_call": 2, "warm_chunks": 1}),
    "urban.sweep_tta": ({"tile": 128, "crop": 64},
                        {"pool": 4, "batch": 2, "warm": 2, "sample": 2,
                         "sample_span": 4}),
    "vaihingen.single_fast_tta": ({"tile": 64, "crop": 64},
                                  {"pool": 4, "warm": 2, "rate": 10,
                                   "sample": 2, "sample_span": 3}),
}


def tiny_context(cell: str, seed: int = 2**31 + 11, seconds: float = 0.5,
                 dtype: str = "float32", calibrate: bool = False
                 ) -> Context:
    """The cell's context on the CPU at its tiny size, computing in
    ``dtype`` (the configuration's ``compute_dtype``)."""
    spec = Spec()
    entry = spec.cell(cell)
    conf = copy.deepcopy(spec.config(entry["config"]))
    traffic = copy.deepcopy(spec.traffic(entry["traffic"]))
    conf.update(TINY_CONFIG, **TINY[cell][0])
    conf["compute_dtype"] = dtype
    traffic.update(TINY[cell][1])
    return Context(cell=cell, config=conf, traffic=traffic, seed=seed,
                   seconds=seconds, trace=False, device="cpu",
                   calibrate=calibrate)


def one_thread():
    """Run the CPU tests' PyTorch on few threads (several test workers
    share the host)."""
    import torch

    torch.set_num_threads(2)

"""The port's tracer (``uemda_tpu_torch/utils/trace.py``) on the CPU: off,
it records nothing and opens no profiler range; on, its spans are totalled
by path with their self times, its counters add up across threads, its
spans land in a ``torch.profiler`` chrome trace as ``user_annotation``
events, and a phase is a host span. The instrumented layers: the decode
stage's names, depth counter and worker spans, ``run_training_loop
--profile-dir`` writing ``spans.json`` beside ``trace.json``, and
``run_regen_chunks --profile-dir`` adding the sweeps and evaluations to
it. ``profile_summary``'s span table and its idle attribution on a
hand-made trace."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from uemda_tpu_torch.datasets.meta import NORM_STATS, IsprsDA
from uemda_tpu_torch.datasets.prefetch import prefetch
from uemda_tpu_torch.datasets.synthetic import synthetic_split
from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
from uemda_tpu_torch.train.loop import run_regen_chunks, run_training_loop
from uemda_tpu_torch.utils import trace


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trace.reset()
    assert not trace.enabled()
    a, b = trace.span("x"), trace.span("y")
    assert a is b   # one shared no-op
    with a as sp:
        sp.discard()
        trace.count("c", 3)
        with trace.phases("cpu"):
            trace.phase("forward")
    trace.phase("update")   # no step open: nothing either way
    assert trace.here() is None
    assert trace.snapshot() == {"spans": {}, "counters": {}, "phases": {},
                                "replays": {"n": 0, "ns": 0, "lost": 0}}


def test_spans_nest_by_path_with_self_time_and_counters(tracing,
                                                        monkeypatch):
    """Spans are totalled by path: the same name under two parents is two
    entries. A span's self time leaves out its children's; a discarded
    span is left out. Outside a profiler session a span opens no
    ``record_function`` range (it would record nothing)."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("step") as step:
        assert step.parent is None and trace.here() == "step"
        with trace.span("step.prepare") as prep:
            assert prep.parent is step
            time.sleep(0.01)
            trace.count("draws", 2)
            with trace.span("upload.wait"):
                time.sleep(0.002)
        with trace.span("step.launch"):
            time.sleep(0.005)
        time.sleep(0.002)
    with trace.span("upload.wait"):
        pass
    with trace.span("wait") as sp:
        sp.discard()
    trace.count("draws")
    snap = trace.snapshot()
    s = snap["spans"]
    assert set(s) == {"step", "step/step.prepare", "step/step.launch",
                      "step/step.prepare/upload.wait", "upload.wait"}
    assert all(v["n"] == 1 for v in s.values())
    prep, launch = s["step/step.prepare"], s["step/step.launch"]
    inner = s["step/step.prepare/upload.wait"]
    assert s["step"]["self_ns"] == s["step"]["total_ns"] \
        - prep["total_ns"] - launch["total_ns"] >= 2e6
    assert prep["self_ns"] == prep["total_ns"] - inner["total_ns"] >= 1e7
    assert inner["self_ns"] == inner["total_ns"] >= 2e6
    assert s["upload.wait"]["total_ns"] < inner["total_ns"]
    assert snap["counters"] == {"draws": 3}


def test_counters_and_spans_of_many_threads_add_up(tracing):
    """More threads than cores, a short switch interval: no count lost."""
    import sys

    def work():
        for _ in range(500):
            with trace.span("w"):
                trace.count("n")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = trace.snapshot()
    assert snap["counters"]["n"] == 16 * 500 and snap["spans"]["w"]["n"] == 8000


def test_spans_and_cpu_phases_land_in_a_chrome_trace(tracing, tmp_path):
    """Under ``torch.profiler`` (CPU) each span, and each phase of a CPU
    step (a host span ``phase.<name>``, its time the host's), is a
    ``user_annotation`` event around the operators run inside it."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step"):
            with trace.phases("cpu"):
                trace.phase("forward")
                y = x @ x
                trace.phase("update")
                y.add_(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"step", "phase.forward", "phase.update"} <= set(ann)
    mm = [e for e in events if e.get("name") == "aten::mm"]
    fwd = ann["phase.forward"]
    assert any(fwd["ts"] <= e["ts"] <= fwd["ts"] + fwd["dur"] for e in mm)
    snap = trace.snapshot()
    assert snap["spans"]["step/phase.forward"]["n"] == 1
    assert snap["spans"]["step/phase.update"]["n"] == 1
    assert snap["phases"] == {} and snap["replays"]["n"] == 0
    # a phase marked inside a span ends the phase before it all the same
    with trace.phases("cpu"):
        trace.phase("a")
        with trace.span("inner"):
            trace.phase("b")
    with trace.span("after") as sp:
        assert sp.parent is None


def test_prefetch_names_its_wait_and_counts_its_depth(tracing):
    """Its worker's spans hang under the span open where the first item
    was asked for."""
    def produce(n):
        for i in range(n):
            with trace.span("make"):
                pass
            yield i

    items = list(prefetch(produce(5), depth=2, name="upload"))
    assert items == list(range(5))
    snap = trace.snapshot()
    # five gets found an item; the sixth found the end and is left out
    assert snap["spans"]["upload.wait"]["n"] == 5
    assert snap["spans"]["make"]["n"] == 5
    assert "upload.depth" in snap["counters"] and "decode.wait" not in \
        snap["spans"]
    assert 0 <= snap["counters"]["upload.depth"] <= 2 * 6
    it = prefetch(produce(3))
    with trace.span("serve.batch"):
        first = next(it)
    assert [first] + list(it) == [0, 1, 2]
    s = trace.snapshot()["spans"]
    assert s["serve.batch/decode.wait"]["n"] == 1
    assert s["decode.wait"]["n"] == 2
    assert s["serve.batch/make"]["n"] == 3 and s["make"]["n"] == 5


class _Toy:
    def __init__(self):
        self.step = 0
        self.model = torch.nn.Linear(1, 1)


def _phased_step(state, bs, bt, seed):
    with trace.phases("cpu"):
        trace.phase("forward")
        x = bs["x"].sum() + bt["x"].sum()
        trace.phase("update")
        x = x + 1
    state.step += 1
    return {"x": x}


def _stream():
    i = 0
    while True:
        yield {"x": np.array([i % 7], np.float32)}
        i += 1


@pytest.mark.parametrize("k", [1, 3])
def test_profile_dir_writes_spans_beside_the_trace(tmp_path, k):
    """``profile_dir`` turns the tracer on for the run (steps 10-15 traced
    alone, chunks of ``k`` after) and off at its end, and writes
    ``spans.json`` beside ``trace.json``: every step's ``step`` span, the
    upload stage's waits, the decode stage's and the step's phases (on
    the CPU, host spans); the trace holds them as ranges."""
    import logging

    assert not trace.enabled()
    out = tmp_path / "prof"
    run_training_loop(_Toy(), _phased_step, prefetch(_stream()),
                      prefetch(_stream()), 20, logging.getLogger("toy"),
                      eval_every=100, log_every=100, steps_per_call=k,
                      profile_dir=str(out))
    assert not trace.enabled()
    rec = json.loads((out / "spans.json").read_text())
    spans = rec["spans"]
    assert spans["step"]["n"] == 20
    # on the CPU the upload stage reads the decode stage on the loop's thread
    assert spans["upload.wait"]["n"] == 40
    assert spans["upload.wait/decode.wait"]["n"] == 40
    assert spans["step/phase.forward"]["n"] == 20
    assert spans["step/phase.update"]["n"] == 20
    assert spans["step"]["mean_ms"] > 0 and "decode.depth" in rec["counters"]
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"step", "upload.wait", "phase.forward"} <= names
    trace.reset()


def profile_regen_run(out, device):
    """``run_regen_chunks`` with ``profile_dir``: 8 toy steps in two chunks
    of 4, a sweep (``generate_pseudo_labels`` of three 32^2 images at
    batch 2 through a 1x1 convolution on ``device``) before each chunk, and
    an evaluation running the same sweep at each chunk's step 4. Returns
    the ``spans.json`` written."""
    import logging

    net = torch.nn.Sequential(torch.nn.Conv2d(3, 6, 1),
                              torch.nn.Softmax(dim=1)).to(device)
    data = synthetic_split(IsprsDA, n=3, hw=32, seed=3)
    st = NORM_STATS["Vaihingen"]

    def sweep():
        generate_pseudo_labels(net, data, st["mean"], st["std"],
                               tile=(32, 32), tta=False, batch_size=2,
                               compute_dtype=torch.float32, device=device)

    def evaluate(state):
        sweep()
        return 0.0

    assert not trace.enabled()
    run_regen_chunks(_Toy(), _phased_step, 8, 4, 0, logging.getLogger("toy"),
                     sweep, lambda skip: prefetch(_stream()),
                     lambda skip: prefetch(_stream()), eval_fn=evaluate,
                     eval_every=4, log_every=100, profile_dir=str(out))
    assert not trace.enabled()
    trace.reset()
    return json.loads((out / "spans.json").read_text())


def test_profile_dir_spans_the_sweeps_and_evaluations(tmp_path):
    """The sweeps before each chunk land in the run's ``spans.json``, and
    the evaluations' batches apart from them, under ``loop.eval``."""
    spans = profile_regen_run(tmp_path / "prof", "cpu")["spans"]
    assert spans["step"]["n"] == 8
    assert spans["serve.batch"]["n"] == 2 * 2
    assert spans["serve.batch/upload.wait"]["n"] == 2 * 2
    assert spans["serve.batch/predict.call"]["n"] == 2 * 2
    assert spans["loop.eval"]["n"] == 2
    assert spans["loop.eval/serve.batch"]["n"] == 2 * 2
    assert spans["loop.eval/serve.batch/predict.call"]["n"] == 2 * 2


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_profile_summary_spans_and_idle_by_span():
    """A gap whose ending launch was issued under a nested span goes to the
    innermost; one issued under no span goes to none; a span's self time
    leaves out its children."""
    from uemda_tpu_torch.tools.profile_summary import (
        idle_by_span,
        program_spans,
    )

    events = [
        _x("user_annotation", "step", 0, 100),
        _x("user_annotation", "step.prepare", 10, 30),
        _x("user_annotation", "other", 0, 100, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        _x("cuda_runtime", "cudaMemcpyAsync", 20, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 1, corr=3),
        _x("kernel", "a", 6, 4, tid=7, corr=1),
        _x("gpu_memcpy", "copy", 25, 5, tid=7, corr=2),   # gap 15 ns
        _x("kernel", "b", 130, 10, tid=7, corr=3),        # gap 100 ns
    ]
    idle = idle_by_span(events)
    assert idle["spans"] == {"step.prepare": 15} and idle["none"] == 100
    assert idle["gaps"] == [(100, None), (15, "step.prepare")]
    assert idle_by_span(events, names={"step"})["spans"] == {"step": 15}
    spans = program_spans(events)
    assert spans["step"] == {"n": 1, "total_us": 0.1, "self_us": 0.07}
    assert spans["step.prepare"]["self_us"] == 0.03

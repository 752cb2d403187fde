"""The port's last modules against the JAX package on the CPU:
``make_synthetic_dataset``'s hard-shift knobs (``pad_border``, ``noise``,
``palette_mix``; every written PNG and ``.tif`` array equal), ``coral_loss``
with ``is_sqrt`` and ``coral_loss2`` (rtol 1e-6), ``AverageMeter`` and
``BestLog`` (equal sequences), ``kfold_indices`` (equal), ``slide_predict``
(ResNet-18, 64^2 tiles, f32: atol 1e-5) and the port's twins of the five
synthetic-pair configs under ``runs/`` (the generator calls they make,
recorded instead of run, and ``snapshot_config``'s bytes equal)."""

import dataclasses
import filecmp
import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from tests.torch_port_helpers import (  # noqa: F401 (one_cpu_thread)
    models_from_port,
    one_cpu_thread,
    to_nhwc,
    to_torch,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(root):
    """{relative path: array} of every file a synthetic dataset wrote."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = np.asarray(Image.open(p))
    return out


@pytest.mark.parametrize("meta_name, kw", [
    ("LoveDA", dict(pad_border=8, domain_shift=12.0)),
    ("IsprsDA", dict(noise=45.0, palette_mix=0.25, domain_shift=8.0)),
    ("LoveDA", dict(pad_border=5, noise=40.0, palette_mix=0.1,
                    with_sup=False)),
])
def test_synthetic_hard_shift_knobs_write_jax_arrays(meta_name, kw, tmp_path):
    """The same seed writes the same images, masks (the raw-0 border on
    every even tile) and superpixel maps as JAX's generator."""
    from uemda_tpu.datasets import meta as jax_meta
    from uemda_tpu.datasets.synthetic import make_synthetic_dataset as jax_make
    from uemda_tpu_torch.datasets import meta
    from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset

    args = dict(n_train=3, n_val=2, hw=64, seed=7, **kw)
    got = make_synthetic_dataset(str(tmp_path / "port"),
                                 getattr(meta, meta_name), **args)
    want = jax_make(str(tmp_path / "jax"), getattr(jax_meta, meta_name),
                    **args)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    a, b = _arrays(tmp_path / "port"), _arrays(tmp_path / "jax")
    assert sorted(a) == sorted(b) and len(a) == (15 if kw.get(
        "with_sup", True) else 10)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    if kw.get("pad_border"):
        pb = kw["pad_border"]
        mask = a[os.path.join("ann_dir", "train", "tile_000.png")]
        assert (mask[:pb] == 0).all() and (mask[:, :pb] == 0).all()
        odd = a[os.path.join("ann_dir", "train", "tile_001.png")]
        assert (odd > 0).all()   # LoveDA raw labels are 1..7 off the border


@pytest.mark.parametrize("is_sqrt", [False, True])
def test_coral_is_sqrt_and_coral_loss2_match_jax(is_sqrt):
    """``coral_loss(is_sqrt)`` and the expanded ``coral_loss2`` on features
    with a non-zero mean, f32, against JAX's at rtol 1e-6."""
    from uemda_tpu.alignment import coral as jax_coral
    from uemda_tpu_torch.alignment import coral

    rng = np.random.default_rng(3)
    s = (rng.normal(size=(300, 24)) + 0.5).astype(np.float32)
    t = (rng.normal(size=(260, 24)) * 1.3 - 0.2).astype(np.float32)
    for name in ("coral_loss", "coral_loss2"):
        got = getattr(coral, name)(torch.from_numpy(s), torch.from_numpy(t),
                                   is_sqrt=is_sqrt)
        want = getattr(jax_coral, name)(jnp.asarray(s), jnp.asarray(t),
                                        is_sqrt=is_sqrt)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)


def test_average_meter_and_best_log_sequences_equal_jax():
    """The same updates give the same value, sum, count, average, best and
    return values, ties included, for both directions of ``BestLog``."""
    from uemda_tpu.utils import log as jax_log
    from uemda_tpu_torch.utils import log

    updates = [(3.0, 1), (1.5, 4), (2.25, 2), (0.0, 3), (7.5, 1)]
    meters = log.AverageMeter(), jax_log.AverageMeter()
    for val, n in updates:
        for m in meters:
            m.update(val, n)
        assert vars(meters[0]) == vars(meters[1])
    for m in meters:
        m.reset()
    assert vars(meters[0]) == vars(meters[1])
    values = [0.4, 0.6, 0.6, 0.5, 0.7, 0.1, 0.1]
    for high in (True, False):
        logs = log.BestLog(high), jax_log.BestLog(high)
        for it, v in enumerate(values):
            flags = [b.update(v, it, f"iter {it}") for b in logs]
            assert flags[0] == flags[1]
            assert vars(logs[0]) == vars(logs[1])


@pytest.mark.parametrize("n, k, fold", [
    (100, 10, 0), (100, 10, 9), (37, 5, 3), (37, 5, 12), (10, 3, 2),
    (7, 10, 4), (50, 10, -1), (0, 4, 1)])
def test_kfold_indices_equal_jax(n, k, fold):
    from uemda_tpu.datasets.base import kfold_indices as jax_kfold
    from uemda_tpu_torch.datasets.base import kfold_indices

    for seed in (2333, 5):
        got = kfold_indices(n, k, fold, seed)
        want = jax_kfold(n, k, fold, seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("tta", [False, True])
def test_slide_predict_matches_jax(tta, one_cpu_thread, monkeypatch):
    """``slide_predict`` of a (2, 3, 80, 112) batch with 64^2 tiles against
    JAX's (its predictor held to f32) on one seeded ResNet-18: atol 1e-5;
    the port's call captures nothing (an eager predictor)."""
    from uemda_tpu.infer import slide as jax_slide
    from uemda_tpu_torch.infer import slide

    jmodel, variables, tmodel = models_from_port("resnet18", seed=4)
    monkeypatch.setattr(jax_slide, "make_predictor", functools.partial(
        jax_slide.make_predictor, compute_dtype="float32"))
    made = []
    real = slide.make_predictor
    monkeypatch.setattr(slide, "make_predictor", lambda *a, **k: made.append(
        k["capture"]) or real(*a, **k))
    x = np.random.default_rng(1).normal(size=(2, 80, 112, 3)) \
        .astype(np.float32)
    want = np.asarray(jax_slide.slide_predict(jmodel, variables,
                                              jnp.asarray(x), (64, 64), tta))
    got = slide.slide_predict(tmodel, to_torch(x), (64, 64), tta,
                              compute_dtype=torch.float32)
    assert made == [False] and got.shape == (2, 6, 80, 112)
    np.testing.assert_allclose(to_nhwc(got), want, atol=1e-5, rtol=0)


TWINS = ("loveda_synth", "full_synth", "fullref", "ablation", "ablation2")


def _load_recording(monkeypatch, load_config, module, path):
    """``load_config(path)`` with ``module.make_synthetic_dataset`` replaced
    by a recorder and every ``/tmp/uemda*`` directory reported absent, so
    the config asks for all of its data and nothing is written. Returns
    (config, [(root, meta as a dict, kwargs)])."""
    calls = []
    monkeypatch.setattr(module, "make_synthetic_dataset",
                        lambda root, meta, **kw: calls.append(
                            (root, dataclasses.asdict(meta), kw)))
    real = os.path.isdir
    monkeypatch.setattr(os.path, "isdir", lambda p: False if str(p)
                        .startswith("/tmp/uemda") else real(p))
    cfg = load_config(path)
    monkeypatch.setattr(os.path, "isdir", real)
    return cfg, calls


@pytest.mark.parametrize("name", TWINS)
@pytest.mark.parametrize("env", [{}, {"UEMDA_ABL2_NOISE": "45",
                                      "UEMDA_ABL2_PMIX": "0.25",
                                      "UEMDA_ABL_LOG": "/tmp/uemda_x/log",
                                      "UEMDA_FULLREF_LOG": "/tmp/uemda_y"}],
                         ids=["defaults", "env"])
def test_config_twins_match_the_jax_configs(name, env, tmp_path, monkeypatch):
    """Each ``uemda_tpu_torch/runs/<name>_config.py`` asks for the same
    synthetic data (roots, metas, generator arguments, in order) as
    ``runs/<name>_config.py`` and resolves to a config whose
    ``snapshot_config`` bytes are the JAX one's."""
    import uemda_tpu.datasets.synthetic as jax_synth
    import uemda_tpu_torch.datasets.synthetic as synth
    from uemda_tpu.config import load_config as jax_load_config
    from uemda_tpu.config import snapshot_config as jax_snapshot
    from uemda_tpu_torch.config import load_config, snapshot_config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port_file = os.path.join(ROOT, "uemda_tpu_torch", "runs",
                             f"{name}_config.py")
    jax_file = os.path.join(ROOT, "runs", f"{name}_config.py")
    cfg, calls = _load_recording(monkeypatch, load_config, synth, port_file)
    jcfg, jcalls = _load_recording(monkeypatch, jax_load_config, jax_synth,
                                   jax_file)
    assert calls == jcalls and len(calls) == 2
    snapshot_config(cfg, str(tmp_path / "port"))
    jax_snapshot(jcfg, str(tmp_path / "jax"))
    assert filecmp.cmp(tmp_path / "port" / "config.json",
                       tmp_path / "jax" / "config.json", shallow=False)

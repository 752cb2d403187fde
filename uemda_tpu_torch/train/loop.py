"""The stage-1 trainer: model and state construction, the data
streams, and a minimal step loop with periodic evaluation and
best-checkpoint tracking.

The port's copy of ``build_model``, ``build_state``, ``default_hparams``,
``make_source_iter`` and ``make_target_iter`` (``uemda_tpu/train/loop.py:
44-116,615-663``), and a loop in the manner of ``_run_training_loop``
(reference ``tools/train_src.py:108-165``): log every ``log_every`` steps,
evaluate every ``eval_every`` steps and at the end through
``infer/evaluate.py``, keep the best checkpoint as a ``.pth`` under the
reference's key names. Resume, the run-dir lock, the hang watchdog and
several steps per call are not ported yet (ROADMAP.md queue A).
"""

import copy
import dataclasses
import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from uemda_tpu_torch.config import PairConfig
from uemda_tpu_torch.datasets.base import SegDataset, infinite_batches
from uemda_tpu_torch.infer.evaluate import evaluate_dataset
from uemda_tpu_torch.models.config import DeeplabV2Config, PPMConfig
from uemda_tpu_torch.models.deeplabv2 import DeeplabV2
from uemda_tpu_torch.models.resnet import ResNetEncoder
from uemda_tpu_torch.train.lr import poly_warmup_schedule
from uemda_tpu_torch.train.optim import SGD, freeze_mask
from uemda_tpu_torch.train.state import TrainState
from uemda_tpu_torch.train.steps import StageHParams


def resolve_model_name(model: str) -> str:
    name = str(model).lower()
    return "resnet50" if name == "resnet" else name


def build_model(cfg: PairConfig, device=None,
                generator: Optional[torch.Generator] = None) -> DeeplabV2:
    """The one model config every reference tool uses (train_src.py:63-80);
    head and feature widths follow the backbone (2048 for resnet50/101).
    ``generator`` draws the random init."""
    name = resolve_model_name(cfg.model)
    fc_dim = ResNetEncoder.out_channels(name)
    mcfg = DeeplabV2Config.uemda_default(num_classes=cfg.class_num,
                                         resnet_type=name)
    if fc_dim != 2048:
        mcfg = dataclasses.replace(
            mcfg, ppm=PPMConfig(num_classes=cfg.class_num, fc_dim=fc_dim),
            inchannels=fc_dim)
    return DeeplabV2(mcfg, device=device, generator=generator)


def build_state(model: DeeplabV2, cfg: PairConfig, stop_steps: int,
                freeze_at: int = 0, accum_steps: int = 1) -> TrainState:
    """SGD over the model's parameters with the poly-warmup schedule over
    ``stop_steps`` and, for ``freeze_at > 0``, the stage freeze mask."""
    schedule = poly_warmup_schedule(cfg.learning_rate, stop_steps, cfg.power)
    named = list(model.named_parameters())
    mask = freeze_mask(named, freeze_at) if freeze_at > 0 else None
    opt = SGD(named, schedule, cfg.momentum, cfg.weight_decay, clip_norm=32.0,
              trainable=mask, accum_steps=accum_steps)
    return TrainState(step=0, model=model, opt=opt)


def default_hparams(cfg: PairConfig, **overrides) -> StageHParams:
    base = dict(
        class_num=cfg.class_num,
        ignore_label=cfg.ignore_label,
        crop=cfg.crop,
        src_mean=cfg.source.mean,
        src_std=cfg.source.std,
        tgt_mean=cfg.target.mean,
        tgt_std=cfg.target.std,
    )
    base.update(overrides)
    return StageHParams(**base)


def make_source_iter(cfg: PairConfig, seed: int = 0):
    ds = SegDataset(cfg.meta, list(cfg.source.image_dir),
                    list(cfg.source.mask_dir)[0])
    return infinite_batches(ds, cfg.source.batch_size, seed=seed), ds


def make_target_iter(cfg: PairConfig, seed: int = 1):
    """The unlabelled target stream (images only)."""
    ds = SegDataset(cfg.meta, list(cfg.target.image_dir), None)
    return infinite_batches(ds, cfg.target.batch_size, seed=seed), ds


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Raw host arrays -> tensors on ``device`` (uint8 images stay uint8:
    the crop kernel casts them on load). To the card they go from pinned
    memory without blocking: a copy from pageable memory would hold the
    host until the device had finished the previous step."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_eval_hook(cfg: PairConfig, run_dir: Optional[str], dataset=None,
                   logger: Optional[logging.Logger] = None):
    """Evaluation on the val split (or ``dataset``) through
    ``evaluate_dataset``, on an eval-mode copy of the model in bf16 on the
    card (f32 on the CPU); ``on_best`` saves ``<target>_best.pth`` (the
    model's state dict, reference key names) under ``run_dir``."""
    split = cfg.val
    if dataset is None:
        dataset = SegDataset(cfg.meta, list(split.image_dir),
                             list(split.mask_dir)[0])

    def eval_fn(state: TrainState) -> float:
        dev = next(state.model.parameters()).device
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        model = copy.deepcopy(state.model).eval().to(dtype)
        with torch.no_grad():
            _, miou = evaluate_dataset(
                model, dataset, split.mean, split.std, tile=cfg.crop,
                batch_size=split.batch_size, compute_dtype=dtype, device=dev,
                logger=logger)
        return miou

    def on_best(state: TrainState, step: int, miou: float):
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            torch.save(state.model.state_dict(),
                       os.path.join(run_dir, f"{cfg.target_set}_best.pth"))

    return eval_fn, on_best


def run_training_loop(state: TrainState, step_fn: Callable, source_iter,
                      target_iter, stop_steps: int, logger: logging.Logger,
                      eval_every: int = 500, log_every: int = 50,
                      eval_fn: Optional[Callable] = None,
                      on_best: Optional[Callable] = None,
                      seed: int = 2333, on_step: Optional[Callable] = None
                      ) -> Dict[str, float]:
    """Steps ``state.step`` up to ``stop_steps``; host batches go to the
    model's device. Returns {'miou': best, 'step': its step}. ``on_step``
    (step, metrics) sees every step's device metrics without a host
    synchronisation."""
    dev = next(state.model.parameters()).device
    miou_max, iter_max = 0.0, 0
    t0 = time.time()
    while state.step < stop_steps:
        batch_s = batch_to_device(next(source_iter), dev)
        batch_t = (batch_to_device(next(target_iter), dev)
                   if target_iter is not None else None)
        metrics = step_fn(state, batch_s, batch_t, seed)
        i = state.step
        if on_step is not None:
            on_step(i, metrics)
        if i == 1 or i % log_every == 0:
            msg = ", ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
            logger.info(f"iter={i}/{stop_steps}, {msg}")
        if eval_fn is not None and (i % eval_every == 0 or i >= stop_steps):
            miou = eval_fn(state)
            if miou >= miou_max:
                miou_max, iter_max = miou, i
                if on_best is not None:
                    on_best(state, i, miou)
            logger.info(f"eval@{i}: mIoU={miou:.5f} (best {miou_max:.5f} @ "
                        f"iter {iter_max})")
    logger.info(f">>>> used {(time.time() - t0) / 3600:.3f} hours")
    return {"miou": miou_max, "step": iter_max}

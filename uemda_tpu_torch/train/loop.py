"""The trainers of stages 1-3: model and state construction, the data
streams, and the step loop with periodic evaluation and best-checkpoint
tracking.

The port's copy of ``build_model``, ``build_state``, ``default_hparams``,
``_max_segments_for``, ``add_loop_flags``, ``host_crop_of``,
``make_source_iter`` and ``make_target_iter`` (``uemda_tpu/train/loop.py:
44-116,278-299,615-675``), and of ``_run_training_loop`` (``loop.py:
302-522``; reference ``tools/train_src.py:108-165``): log every
``log_every`` steps, evaluate every ``eval_every`` steps and at the end
through ``infer/evaluate.py``, keep the best checkpoint as a ``.pth`` under
the reference's key names, the prototypes beside it and ``best.json``
(``{"miou", "step"}``, as ``uemda_tpu/train/loop.py:382-397``), which the
pipeline's regression check reads.

The host path, as the JAX package's: a decode stage (``datasets/
prefetch.py``) and an upload stage (``upload_batches`` there: a worker
thread with its own CUDA stream and a ring of reused pinned buffers) feed
the loop, ``--host-crop`` crops each sample on the host before its upload,
and ``steps_per_call`` K runs chunks of K steps, on the card as replays of
a CUDA graph of the step (``train/graph.py``), under the JAX package's
chunk rule. ``profile_dir`` traces steps 10-15 with ``torch.profiler``.

The state on disk, as ``uemda_tpu/train/loop.py:121-184,302-549,571-574``:
with ``state_path`` the loop locks its run dir (``train/checkpoints.py``'s
``RunDirLock``), reads ``best.json`` so that a resumed run never lets a
worse model overwrite ``_best``, appends every logged step's metrics and
every evaluation's mIoU to ``metrics.jsonl``, snapshots the whole train
state (``TrainState.state_dict``) through an ``AsyncSaver`` before each
evaluation and at the end (unless the last evaluation's snapshot holds
that step already), and :func:`maybe_resume` restores it. The metric readback, the snapshot, the evaluation and the final save
run under a deadline (``UEMDA_HANG_TIMEOUT_S``, 900 s by default, 0 off):
a hung device raises ``TimeoutError`` instead of hanging the run.

The mix, DCA and UVEM-ablation trainers run in ``GENE_EVERY`` chunks
with a pseudo-label sweep between them (:func:`run_regen_chunks`;
:func:`sweep_streams` for the last two).

Data parallelism (``parallel/``, as ``uemda_tpu/train/loop.py:310-400,
598-643``): every rank runs the same loop on its rows of each global
batch (:func:`process_shard` in every stream), and process 0 alone locks
the run dir, reads back and logs the metrics, writes ``metrics.jsonl``,
``best.json``, the snapshots and the checkpoints, and evaluates. The other
ranks never read back, so no deadline runs on them: they wait at the next
step's first collective while process 0 evaluates.
"""

import copy
import dataclasses
import json
import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from uemda_tpu_torch.alignment.balance import init_class_balance
from uemda_tpu_torch.alignment.losses import init_ghm
from uemda_tpu_torch.alignment.prototypes import init_aligner
from uemda_tpu_torch.config import PairConfig
from uemda_tpu_torch.datasets.base import SegDataset, infinite_batches
from uemda_tpu_torch.datasets.prefetch import prefetch, upload_batches
from uemda_tpu_torch.infer.evaluate import evaluate_dataset
from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
from uemda_tpu_torch.models.config import DeeplabV2Config, PPMConfig
from uemda_tpu_torch.models.deeplabv2 import DeeplabV2
from uemda_tpu_torch.models.port import load_pretrained_backbone
from uemda_tpu_torch.models.resnet import ResNetEncoder
from uemda_tpu_torch.parallel.multihost import (
    add_multihost_flags,
    is_main_process,
    local_batch_slice,
    process_count,
)
from uemda_tpu_torch.train.checkpoints import (
    AsyncSaver,
    RunDirLock,
    load_checkpoint,
    save_checkpoint,
)
from uemda_tpu_torch.train.graph import ChunkRunner
from uemda_tpu_torch.train.lr import poly_warmup_schedule
from uemda_tpu_torch.train.optim import SGD, freeze_mask
from uemda_tpu_torch.train.state import TrainState
from uemda_tpu_torch.train.steps import StageHParams


def resolve_model_name(model: str) -> str:
    name = str(model).lower()
    return "resnet50" if name == "resnet" else name


def build_model(cfg: PairConfig, device=None,
                generator: Optional[torch.Generator] = None,
                pretrained: Optional[str] = None) -> DeeplabV2:
    """The one model config every reference tool uses (train_src.py:63-80);
    head and feature widths follow the backbone (2048 for resnet50/101).
    ``generator`` draws the random init. ``pretrained``: a torchvision-style
    ImageNet ``.pth``/``.pt`` loaded into the trunk, the heads keeping their
    init (``uemda_tpu/train/loop.py:75-81``, :func:`models.port.
    load_pretrained_backbone`)."""
    name = resolve_model_name(cfg.model)
    fc_dim = ResNetEncoder.out_channels(name)
    mcfg = DeeplabV2Config.uemda_default(num_classes=cfg.class_num,
                                         resnet_type=name,
                                         pretrained=pretrained)
    if fc_dim != 2048:
        mcfg = dataclasses.replace(
            mcfg, ppm=PPMConfig(num_classes=cfg.class_num, fc_dim=fc_dim),
            inchannels=fc_dim)
    model = DeeplabV2(mcfg, device=device, generator=generator)
    if pretrained:
        load_pretrained_backbone(model, pretrained)
    return model


def build_state(model: DeeplabV2, cfg: PairConfig, stop_steps: int,
                freeze_at: int = 0, accum_steps: int = 1, prototypes=None,
                feat_channels: Optional[int] = None,
                balance_temp: float = 2.0) -> TrainState:
    """SGD over the model's parameters with the poly-warmup schedule over
    ``stop_steps`` and, for ``freeze_at > 0``, the stage freeze mask; with
    ``accum_steps`` k > 1 one update per k micro-steps, and the schedule's
    horizon is the number of updates, ceil(stop_steps / k)
    (``uemda_tpu/train/loop.py:100-102``). The prototype aligner starts
    from ``prototypes`` ((C, K), else zeros; K is ``feat_channels``, by
    default the model's ``inchannels``), both class balances from uniform
    frequencies (EMA decay 0.99, temperature ``balance_temp``,
    ``uemda_tpu/train/state.py:62-63``) and the GHM/GDP histogram from
    zeros (30 bins, momentum 0.99), all on the model's device."""
    schedule = poly_warmup_schedule(cfg.learning_rate,
                                    -(-stop_steps // max(accum_steps, 1)),
                                    cfg.power)
    named = list(model.named_parameters())
    mask = freeze_mask(named, freeze_at) if freeze_at > 0 else None
    opt = SGD(named, schedule, cfg.momentum, cfg.weight_decay, clip_norm=32.0,
              trainable=mask, accum_steps=accum_steps)
    dev = named[0][1].device
    aligner = init_aligner(cfg.class_num,
                           feat_channels or model.config.inchannels,
                           ignore_label=cfg.ignore_label,
                           prototypes=prototypes, device=dev)
    return TrainState(
        step=0, model=model, opt=opt, aligner=aligner,
        balance_s=init_class_balance(cfg.class_num, 0.99, balance_temp, dev),
        balance_t=init_class_balance(cfg.class_num, 0.99, balance_temp, dev),
        ghm=init_ghm(device=dev))


def default_hparams(cfg: PairConfig, **overrides) -> StageHParams:
    base = dict(
        class_num=cfg.class_num,
        ignore_label=cfg.ignore_label,
        crop=cfg.crop,
        src_mean=cfg.source.mean,
        src_std=cfg.source.std,
        tgt_mean=cfg.target.mean,
        tgt_std=cfg.target.std,
        cutoff_top=cfg.cutoff_top,
        cutoff_low=cfg.cutoff_low,
        max_segments=max_segments_for(cfg),
        clamp_target=cfg.clamp_target,
    )
    base.update(overrides)
    return StageHParams(**base)


def source_loss_of(args) -> str:
    """A trainer's ``--ls`` as ``StageHParams.source_loss``."""
    return "ohem" if args.ls == "OhemCrossEntropy" else "ce"


def max_segments_for(cfg: PairConfig) -> int:
    """The static bound on superpixel ids + 1 (``loop.py:666-675``): LSC at
    region size 16 gives at most (h/16)(w/16) ids and one boundary id,
    with 32 of slack. The ids are numbered over the whole image before the
    crop, so the bound comes from the larger of image and crop: 4128 for
    LoveDA's 1024^2 tiles, 1056 for 512^2 ISPRS tiles."""
    h = max(cfg.crop[0], cfg.meta.size[0])
    w = max(cfg.crop[1], cfg.meta.size[1])
    return (h // 16) * (w // 16) + 32


def add_loop_flags(parser) -> None:
    """The trainers' shared loop flags (``loop.py:278-293``)."""
    from uemda_tpu_torch.utils.log import str2bool

    parser.add_argument("--steps-per-call", type=int, default=1,
                        help="K steps per call: on the card, replays of a "
                             "CUDA graph of the step, so the host dispatches "
                             "once a step; math, draws and cadences as 1")
    parser.add_argument("--host-crop", type=str2bool, default=0,
                        help="crop each train sample to cfg.crop on the host "
                             "before its upload instead of shipping the "
                             "whole tile (4x less host-to-device traffic at "
                             "1024^2 tiles); the same augmentation law, but "
                             "the crop origins come from a host stream, so "
                             "runs are bit-reproducible only against the "
                             "same flag")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 10-15 "
                             "here")


def add_parallel_flags(parser) -> None:
    """The JAX trainers' data-parallel flags under their names and defaults
    (``tools/train_src.py:61,71``): ``--num-devices`` N > 1 starts N local
    processes, one a device, and ``--multihost``, ``--coordinator``,
    ``--num-processes`` and ``--process-id`` join a group started
    elsewhere (``parallel/multihost.py: launch``)."""
    parser.add_argument("--num-devices", type=int, default=None,
                        help="N > 1: N local processes, rank i on cuda:i (on "
                             "the CPU over gloo with --device cpu), one "
                             "global batch split over them")
    add_multihost_flags(parser)


def process_shard(batch_size: int):
    """This process's (start, size) rows of every global batch under data
    parallelism (``parallel/multihost.py: local_batch_slice``), None for
    one process (``uemda_tpu/train/loop.py:598-609``). Every stream that
    feeds a train step takes it."""
    if process_count() == 1:
        return None
    return local_batch_slice(batch_size)


def host_crop_of(args, cfg) -> object:
    """``cfg.crop`` if the trainer was launched with --host-crop, else None
    (what :func:`make_source_iter` and :func:`make_target_iter` take)."""
    return cfg.crop if getattr(args, "host_crop", False) else None


def make_source_iter(cfg: PairConfig, seed: int = 0, skip: int = 0,
                     host_crop=None):
    """The labelled source stream behind the decode stage's thread."""
    ds = SegDataset(cfg.meta, list(cfg.source.image_dir),
                    list(cfg.source.mask_dir)[0])
    return prefetch(infinite_batches(
        ds, cfg.source.batch_size, seed=seed, skip_batches=skip,
        process_shard=process_shard(cfg.source.batch_size),
        host_crop=host_crop)), ds


def make_target_iter(cfg: PairConfig, seed: int = 1, read_sup: bool = False,
                     prob_dir: Optional[str] = None, skip: int = 0,
                     host_crop=None):
    """The unlabelled target stream behind the decode stage's thread:
    images, with ``read_sup`` their superpixel maps, and with ``prob_dir``
    the soft pseudo labels stage 3's sweep wrote there."""
    ds = SegDataset(cfg.meta, list(cfg.target.image_dir), prob_dir,
                    read_sup=read_sup,
                    label_type="prob" if prob_dir else "none")
    return prefetch(infinite_batches(
        ds, cfg.target.batch_size, seed=seed, skip_batches=skip,
        process_shard=process_shard(cfg.target.batch_size),
        host_crop=host_crop)), ds


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Raw host arrays -> tensors on ``device`` (uint8 images stay uint8:
    the crop kernel casts them on load), one batch on its own: to the card
    from freshly pinned memory without blocking. The loop uploads through
    ``datasets.prefetch.upload_batches`` instead."""
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
    card (f32 on the CPU). With ``run_dir``, each evaluation first saves
    the model's state dict (reference key names) as ``<target>_curr.pth``,
    and ``on_best`` saves ``<target>_best.pth`` and
    ``prototypes_best.pth`` there (``best.json`` is the loop's)."""
    split = cfg.val
    if dataset is None:
        dataset = SegDataset(cfg.meta, list(split.image_dir),
                             list(split.mask_dir)[0])

    def eval_fn(state: TrainState) -> float:
        if run_dir:
            save_checkpoint(os.path.join(run_dir, f"{cfg.target_set}_curr.pth"),
                            state.model.state_dict())
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
            save_checkpoint(os.path.join(run_dir, f"{cfg.target_set}_best.pth"),
                            state.model.state_dict())
            if state.aligner is not None:
                save_checkpoint(os.path.join(run_dir, "prototypes_best.pth"),
                                state.aligner.prototypes.cpu())

    return eval_fn, on_best


def _deadline(fn: Callable, timeout_s: float, what: str):
    """``fn()`` under a wall-clock deadline (``loop.py:155-184``): a hung
    device readback cannot be cancelled, so on expiry the daemon worker is
    abandoned and ``TimeoutError`` raised, with the last snapshot on disk.
    ``timeout_s`` 0 runs ``fn`` on the caller's thread."""
    if not timeout_s:
        return fn()
    q: "queue.Queue" = queue.Queue(maxsize=1)

    def work():
        try:
            q.put((True, fn()))
        except Exception as e:  # noqa: BLE001 - raised by the caller
            q.put((False, e))

    threading.Thread(target=work, daemon=True).start()
    try:
        ok, val = q.get(timeout=timeout_s)
    except queue.Empty:
        raise TimeoutError(
            f"{what} exceeded {timeout_s:.0f}s: the device is presumed hung; "
            "restart with --resume auto from the last state snapshot"
        ) from None
    if not ok:
        raise val
    return val


def maybe_resume(state: TrainState, run_dir: str, resume, logger):
    """A trainer's ``--resume`` (``loop.py:527-549``): ``"auto"`` restores
    ``<run_dir>/state_curr.pth`` if it exists, a path restores that file
    (into ``state``'s own tensors, ``TrainState.load_state_dict``), and a
    fresh start deletes a stale ``best.json`` and ``metrics.jsonl``.
    Returns ``(state, start_step, state_path)``; pass ``state_path`` to
    :func:`run_training_loop` so that it keeps the snapshot fresh.

    The port reads only its own snapshots, not the JAX package's
    ``.msgpack`` ones; a JAX model moves over as weights only, through
    ``tools/port_weights.py --kind export`` (a ``.pth`` the trainers'
    ``--ckpt-model`` loads)."""
    state_path = os.path.join(run_dir, "state_curr.pth")
    src = None
    if resume and resume != "auto":
        src = resume
    elif resume == "auto" and os.path.exists(state_path):
        src = state_path
    if src is None:
        for stale in ("best.json", "metrics.jsonl"):
            p = os.path.join(run_dir, stale)
            if is_main_process() and os.path.exists(p):
                os.remove(p)
        return state, 0, state_path
    state.load_state_dict(load_checkpoint(src))
    logger.info(f"resumed full train state from {src} at step {state.step}")
    return state, state.step, state_path


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, profile_dir: str,
                   logger: logging.Logger) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # a truncated trace is worse than none
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


def run_training_loop(state: TrainState, step_fn: Callable, source_iter,
                      target_iter, stop_steps: int, logger: logging.Logger,
                      eval_every: int = 500, log_every: int = 50,
                      eval_fn: Optional[Callable] = None,
                      on_best: Optional[Callable] = None,
                      seed: int = 2333, on_step: Optional[Callable] = None,
                      steps_per_call: int = 1,
                      profile_dir: Optional[str] = None,
                      state_path: Optional[str] = None, step_offset: int = 0
                      ) -> Dict[str, object]:
    """Steps ``state.step`` up to ``step_offset + stop_steps`` on host
    batches uploaded to the model's device by ``upload_batches``.
    ``on_step`` (step, metrics) sees every step's device metrics without a
    host synchronisation.

    The loop's own count is ``state.step - step_offset``: logs
    (``iter=i/stop_steps``), evaluations, the chunk rule, the profiler's
    window, ``metrics.jsonl`` and ``best.json`` count from ``step_offset``,
    as the JAX loop counts from 0 in each of the mix trainer's chunks.

    ``steps_per_call`` K > 1 runs chunks of K steps (``train/graph.py``:
    replays of a CUDA graph of the step on the card, eager steps on the
    CPU) under the JAX package's rule (``loop.py:412-453``): step 1 runs
    alone, and a chunk runs only where all K steps fit before the next
    log, evaluation and stop boundary, so every boundary lands on a step
    that ends a call and logs fall on the same steps, with the same
    metrics, as at K = 1. ``profile_dir``: a ``torch.profiler`` trace of
    steps 10-15, counted from where the loop starts (none for a run of
    fewer than 2 steps), written there; until it is written every step
    runs alone.

    ``state_path``: the run dir (its directory) is locked for the loop's
    lifetime, and the state is snapshotted there before every evaluation
    and at the end (module docstring). ``UEMDA_HANG_TIMEOUT_S`` (seconds,
    900 by default, 0 off) bounds the readbacks, snapshots and
    evaluations.

    Returns {'miou': best, 'step': its step, 'graph': the capture's
    statistics (``ChunkRunner.close``) or None, 'saver': the snapshot
    writer's ``fetch_s``, ``write_s`` and ``nbytes`` or None}."""
    lock = None
    if state_path and is_main_process():
        lock = RunDirLock(os.path.dirname(os.path.abspath(state_path)))
        lock.acquire()
    try:
        return _run_training_loop(
            state, step_fn, source_iter, target_iter, stop_steps, logger,
            eval_every, log_every, eval_fn, on_best, seed, on_step,
            steps_per_call, profile_dir, state_path, step_offset,
            float(os.environ.get("UEMDA_HANG_TIMEOUT_S", 900.0)))
    finally:
        if lock is not None:
            lock.release()


def _run_training_loop(state, step_fn, source_iter, target_iter, stop_steps,
                       logger, eval_every, log_every, eval_fn, on_best, seed,
                       on_step, steps_per_call, profile_dir, state_path,
                       step_offset, timeout):
    dev = next(state.model.parameters()).device
    # the steps' stream: a deadline's worker thread runs its readback,
    # snapshot copy and evaluation on it, ordered after the steps
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def deadline(fn, what):
        def on_stream():
            if stream is None:
                return fn()
            with torch.cuda.stream(stream):
                return fn()
        return _deadline(on_stream, timeout, what)

    # under data parallelism process 0 alone reads back, logs, evaluates
    # and writes the run dir (module docstring)
    main = is_main_process()
    if not main:
        state_path = eval_fn = on_best = None
    run_dir = os.path.dirname(os.path.abspath(state_path)) if state_path \
        else None
    best_json = os.path.join(run_dir, "best.json") if run_dir else None

    def log_jsonl(record):
        """The loss and mIoU curve, beside the state snapshot."""
        if run_dir:
            with open(os.path.join(run_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")

    miou_max, iter_max = 0.0, 0
    # maybe_resume deletes best.json on a fresh start: here it means a
    # resumed run or a later chunk of the same run
    if best_json and os.path.exists(best_json):
        with open(best_json) as f:
            rec = json.load(f)
        miou_max, iter_max = rec.get("miou", 0.0), rec.get("step", 0)
    k_max = max(1, int(steps_per_call))
    runner = ChunkRunner(step_fn, seed, dev) if k_max > 1 else None
    src = upload_batches(source_iter, dev)
    tgt = upload_batches(target_iter, dev) if target_iter is not None else None
    start = state.step - step_offset
    if profile_dir is not None and stop_steps - start < 2:
        logger.info("profiler needs >= 2 steps; skipping trace")
        profile_dir = None
    trace_start = start + min(10, max(stop_steps - start - 2, 0))
    trace_stop = start + min(15, max(stop_steps - start - 1, 1))
    prof = saver = snapped = None
    hung = False
    t0 = time.time()
    try:
        while state.step - step_offset < stop_steps:
            i = state.step - step_offset
            # every rank keeps the window's single steps; process 0 traces
            if profile_dir is not None and i == trace_start and main:
                prof = _start_profiler(dev)
            if profile_dir is not None and i == trace_stop:
                if prof is not None:
                    _stop_profiler(prof, dev, profile_dir, logger)
                prof = profile_dir = None
            k = 1
            if runner is not None and i > 0 and profile_dir is None:
                fit = min(stop_steps - i, log_every - i % log_every,
                          eval_every - i % eval_every)
                if fit >= k_max:
                    k = k_max
            pairs = ((next(src), next(tgt) if tgt is not None else None)
                     for _ in range(k))
            if k > 1:
                logger.debug(f"steps {i + 1}-{i + k} in one call")
                chunk = runner(state, pairs)
            else:
                chunk = [step_fn(state, *next(pairs), seed)]
            if on_step is not None:
                for j, m in enumerate(chunk):
                    on_step(state.step - len(chunk) + j + 1, m)
            metrics = chunk[-1]
            i = state.step - step_offset
            if main and (i == 1 or i % log_every == 0):
                m = deadline(lambda: {k: float(v) for k, v in metrics.items()},
                             f"metric readback @ iter {i}")
                msg = ", ".join(f"{k}={v:.4g}" for k, v in m.items())
                logger.info(f"iter={i}/{stop_steps}, {msg}")
                log_jsonl({"step": i, **m})
            if eval_fn is not None and (i % eval_every == 0
                                        or i >= stop_steps):
                if state_path:
                    saver = saver or AsyncSaver()
                    # the copy is enqueued after the steps; serialization
                    # and the write go on while the evaluation runs
                    deadline(lambda: saver.save(state_path,
                                                state.state_dict(), stream),
                             f"state snapshot @ iter {i}")
                    snapped = state.step
                miou = deadline(lambda: eval_fn(state), f"eval @ iter {i}")
                if miou >= miou_max:
                    miou_max, iter_max = miou, i
                    if on_best is not None:
                        on_best(state, i, miou)
                    if best_json:
                        with open(best_json, "w") as f:
                            json.dump({"miou": miou_max, "step": iter_max}, f)
                logger.info(f"eval@{i}: mIoU={miou:.5f} (best "
                            f"{miou_max:.5f} @ iter {iter_max})")
                log_jsonl({"step": i, "miou": miou})
        if state_path:
            saver = saver or AsyncSaver()

            def final_save():
                # the last evaluation's snapshot holds this state already
                if snapped != state.step:
                    saver.save(state_path, state.state_dict(), stream)
                saver.wait()
            deadline(final_save, "final state snapshot")
    except TimeoutError:
        hung = True
        raise
    finally:
        if prof is not None:  # never leave a profiler session open
            _stop_profiler(prof, dev, profile_dir, logger)
        src.close()
        if tgt is not None:
            tgt.close()
        stats = runner.close() if runner is not None else None
        saved = None
        if saver is not None:
            saver.close(wait=not hung)  # a snapshot in flight lands
            saved = {"fetch_s": saver.fetch_s, "write_s": saver.write_s,
                     "nbytes": saver.nbytes}
    logger.info(f">>>> used {(time.time() - t0) / 3600:.3f} hours")
    return {"miou": miou_max, "step": iter_max, "graph": stats,
            "saver": saved}


def sweep_streams(model, cfg: PairConfig, pseudo_dir: str, read_sup: bool,
                  host_crop=None, fastpath: bool = False,
                  logger: Optional[logging.Logger] = None):
    """The self-training trainers' ``regen`` and ``target_stream`` for
    :func:`run_regen_chunks`: a sweep of the target split (slide + 8-view
    TTA on an eval-mode copy of ``model``, so the training model and its
    captured step are untouched; bf16 on the card, f32 on the CPU;
    ``fastpath`` on the folded fast path) writing the soft labels to
    ``pseudo_dir``, and the stream of the target images with those labels
    (and, with ``read_sup``, their superpixel maps) from a batch on."""
    device = next(model.parameters()).device
    gen_ds = SegDataset(cfg.meta, list(cfg.target.image_dir), None,
                        label_type="none")

    def regen():
        generate_pseudo_labels(
            model, gen_ds, cfg.target.mean, cfg.target.std,
            out_dir=pseudo_dir, tile=cfg.crop, tta=True,
            batch_size=min(4, cfg.target.batch_size),
            cutoff_top=cfg.cutoff_top, cutoff_low=cfg.cutoff_low,
            keep_in_memory=False,
            compute_dtype=(torch.bfloat16 if device.type == "cuda"
                           else torch.float32),
            device=device, logger=logger, fastpath=fastpath)

    def target_stream(skip: int):
        ds = SegDataset(cfg.meta, list(cfg.target.image_dir), pseudo_dir,
                        label_type="prob", read_sup=read_sup)
        return prefetch(infinite_batches(
            ds, cfg.target.batch_size, seed=1, skip_batches=skip,
            process_shard=process_shard(cfg.target.batch_size),
            host_crop=host_crop))

    return regen, target_stream


def run_regen_chunks(state, step_fn, stop_steps: int, gene_every: int,
                     start: int, logger: logging.Logger, regen: Callable,
                     source_stream: Callable, target_stream: Callable,
                     gen: bool = True, seed: int = 2333,
                     run_loop: Optional[Callable] = None, **loop_kw):
    """The self-training trainers' chunks (``tools/train_ssl_mix.py:
    148-191``, ``train_ssl_dca.py:131-160``, ``train_ssl_uvem_abl.py:
    143-169``): runs of ``gene_every`` steps, each through
    :func:`run_training_loop` counting, logging, evaluating and
    snapshotting from its own start with the seed ``seed`` plus that
    start, and a sweep (``regen()``) of the target split before the first
    chunk and, with ``gen``, between chunks. ``source_stream(skip)`` and
    ``target_stream(skip)``: the source stream and the stream of the last
    sweep's labels, each from its batch ``skip``. A resume (``start`` > 0)
    past the first chunk with ``gen`` regenerates before its first live
    chunk, as the JAX tools do; each live chunk takes fresh streams at the
    step it starts from, so that a resumed run gets the same batches as
    one never stopped (an upload stage reads ahead). ``loop_kw`` goes to
    ``run_loop`` (:func:`run_training_loop` unless given; its
    ``profile_dir`` to the first chunk only). Returns the last chunk's
    result."""
    run_loop = run_loop or run_training_loop
    first_chunk = min(gene_every, stop_steps)
    origin = None   # the step of the last sweep: its stream starts there
    if not (gen and start >= first_chunk):
        regen()
        origin = 0
    profile_dir = loop_kw.pop("profile_dir", None)
    out, done = None, 0
    while done < stop_steps:
        chunk = min(gene_every, stop_steps - done)
        live = state.step < done + chunk
        src_iter = source_stream(state.step) if live else iter(())
        tgt_iter = target_stream(state.step - origin) if live else None
        try:
            out = run_loop(
                state, step_fn, src_iter, tgt_iter, chunk, logger,
                seed=seed + done, step_offset=done,
                profile_dir=profile_dir if done == 0 else None, **loop_kw)
        finally:
            for it in (src_iter, tgt_iter):
                if hasattr(it, "close"):
                    it.close()  # stops its decode thread
        done += chunk
        if done < stop_steps and gen:
            nxt = min(gene_every, stop_steps - done)
            if done + nxt > start:
                logger.info(f"###### regenerating pseudo labels @ step "
                            f"{done} ######")
                regen()
                origin = done
    return out

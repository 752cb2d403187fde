"""What the drivers share: the run's context, the program's configuration
built from the benchmark's configuration file, launch counts, and the
closing of what a driver started."""

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Context:
    """One run of one cell. ``device`` is "cuda" for a measured run; the
    tests drive the same code on "cpu" at a tiny size. ``calibrate`` adds
    the control's and the faults' readings (never in a measured run)."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    calibrate: bool = False

    card_after: Optional[dict] = None
    # (part of set-up, wall s since t_start, CPU s of the process then)
    marks: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The configuration's compute dtype, the program's everywhere."""
        return getattr(torch, self.config["compute_dtype"])

    def mark(self, part: str) -> None:
        """Note that the part of set-up named ``part`` has ended."""
        self.marks.append((part, time.perf_counter() - self.t_start,
                           time.process_time()))

    def after_window(self) -> None:
        """Read the card's clock and power once the window has closed."""
        if torch.device(self.device).type == "cuda":
            from benchmark.harness.device import smi

            self.card_after = smi()

    def log(self, msg: str) -> None:
        print(f"[{self.cell}] {msg}", file=sys.stderr, flush=True)


def pair_config(conf: dict):
    """The program's ``PairConfig`` for the benchmark's configuration file:
    the preset it names, with the file's model, crop and batch; the file's
    classes and normalization must be the preset's."""
    from uemda_tpu_torch.config import PRESETS

    cfg = PRESETS[conf["preset"]]
    cfg = dataclasses.replace(
        cfg, model=conf["arch"], crop=(conf["crop"], conf["crop"]),
        source=dataclasses.replace(cfg.source, batch_size=conf["batch"]),
        target=dataclasses.replace(cfg.target, batch_size=conf["batch"]))
    checks = {"num_classes": cfg.class_num,
              "source_mean": list(cfg.source.mean),
              "source_std": list(cfg.source.std),
              "target_mean": list(cfg.target.mean),
              "target_std": list(cfg.target.std),
              "clamp_target": cfg.clamp_target,
              "learning_rate": cfg.learning_rate,
              "momentum": cfg.momentum, "weight_decay": cfg.weight_decay,
              "power": cfg.power, "cutoff_top": cfg.cutoff_top,
              "cutoff_low": cfg.cutoff_low}
    for k, v in checks.items():
        if conf[k] != v:
            raise ValueError(f"configuration {conf['name']}: {k} is "
                             f"{conf[k]!r}, the program's preset "
                             f"{conf['preset']!r} has {v!r}")
    return cfg


def serve_check(ctx, weights, pool, served, mean, std, tile, tta,
                labels: bool):
    """(readings, calibration readings) of served answers: ``served`` is
    [(pool index, answer)], the answer (H, W) uint8 labels (``labels``) or
    (H, W, C) probabilities; each tile's reference is its f32 slide + TTA
    prediction. When calibrating, the control (the reference computed in
    fp8 in the program's place) is read the same way."""
    import numpy as np

    from benchmark.harness import judge
    from benchmark.reference import model as ref_model, serve as ref_serve

    dev = torch.device(ctx.device)

    def gap(answer, ref):
        if labels:
            return judge.label_gap(answer, ref)
        return judge.prob_gap(answer.permute(2, 0, 1), ref)

    with ref_model.full_f32():
        net = ref_model.Net(weights, ctx.config["arch"])
        low = ref_model.Net(weights, ctx.config["arch"], quant="fp8")
        gaps, ctrl = [], []
        for idx, answer in served:
            img = torch.from_numpy(np.ascontiguousarray(pool[idx])).to(dev)
            ref = ref_serve.slide_tta(net, img, mean, std, tile, tta)
            gaps.append(gap(torch.from_numpy(answer).to(dev), ref))
            if ctx.calibrate:
                lp = ref_serve.slide_tta(low, img, mean, std, tile, tta)
                lp = lp.argmax(0) if labels else lp.permute(1, 2, 0)
                ctrl.append(gap(lp, ref))
    extra = {"control": {"gap": max(ctrl)}} if ctrl else {}
    return {"gap": max(gaps)}, extra


def launch_counts() -> Dict[str, int]:
    from uemda_tpu_torch.infer.graph import kernel_wrappers

    return {w.__name__: w.launches for w in kernel_wrappers()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

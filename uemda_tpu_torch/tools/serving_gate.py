"""Serving-mode quality gate: mIoU and per-class IoU of every serving mode
against the standard forward, on the GPU.

Twin of ``tools/serving_gate.py``::

    python -m uemda_tpu_torch.tools.serving_gate --config-path 2vaihingen \\
        --ckpt-path src/Vaihingen_best.pth,ssl/Vaihingen_best.pth

Before serving a non-default mode (``--fastpath`` / ``--int8``), every mode
of ``--modes`` is evaluated on the validation split of each checkpoint (a
comma list: other stages or seeds, so the int8 error is measured across
feature distributions). The gate holds both the mIoU delta and the worst
per-class IoU delta against ``standard``. Modes: ``standard``,
``fastpath``, ``fastpath_int8`` (dynamic scales, heads + stages 3, 4),
``fastpath_int8cal`` (static scales calibrated on ``--calib-batches`` of
the split), ``fastpath_int8cal_all`` (calibrated, every backbone stage in
int8: the JAX package's headline mode; the port's fast path always has the
K2 stem, so it needs no ``fused_stem`` switch) and ``int8``
(``Int8Model``). Each evaluation runs through ``device_batches`` and, on
the card, a captured predictor. Checkpoints: reference ``.pth`` or the
port's ``.npz``. Prints one JSON line per (checkpoint, mode) and a final
``GATE_RESULT`` line; exits 1 if any checkpoint or mode breaches a
tolerance. ``run_gate`` is what ``run_pipeline --gate 1`` calls.
"""

import argparse
import copy
import json

import torch

from uemda_tpu_torch.utils.log import str2bool

MODES = ("standard", "fastpath", "fastpath_int8", "fastpath_int8cal",
         "fastpath_int8cal_all", "int8")


def gate_checkpoint(cfg, ckpt_path, modes, batch_size, calib_batches,
                    test=False, model=None, device=None):
    """Evaluate every serving mode on one checkpoint. ``model`` lets a
    caller of several checkpoints build the model once (``run_gate``
    does). Returns {mode: {"miou": float, "iou": [..], "class_names":
    [..]}}."""
    from uemda_tpu_torch.datasets.base import SegDataset
    from uemda_tpu_torch.infer.evaluate import evaluate_dataset
    from uemda_tpu_torch.models.port import load_checkpoint
    from uemda_tpu_torch.train.loop import build_model

    if model is None:
        model = build_model(cfg, device)
    model.load_state_dict(load_checkpoint(ckpt_path))
    dev = next(model.parameters()).device
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    split = cfg.test if test else cfg.val
    dataset = SegDataset(cfg.meta, list(split.image_dir),
                         list(split.mask_dir)[0])
    batch = batch_size or split.batch_size
    calib_cache = {}

    def calib(n):
        # mode-independent: collected once per checkpoint
        if n not in calib_cache:
            from uemda_tpu_torch.infer.evaluate import collect_calib_batches

            calib_cache[n] = collect_calib_batches(
                dataset, batch, split.mean, split.std, n, tile=cfg.crop,
                device=dev)
        return calib_cache[n]

    def build(mode):
        if mode == "standard":
            return copy.deepcopy(model).to(dtype)  # the folds read f32
        if mode in ("fastpath", "fastpath_int8", "fastpath_int8cal",
                    "fastpath_int8cal_all"):
            from uemda_tpu_torch.infer.fastpath import build_fastpath

            return build_fastpath(
                model, dtype=dtype, int8="int8" in mode,
                # _all: calibrated int8 on every backbone stage
                int8_stages=(1, 2, 3, 4) if mode.endswith("_all") else None,
                calibration_batches=(calib(calib_batches)
                                     if mode.startswith("fastpath_int8cal")
                                     else None))
        if mode == "int8":
            from uemda_tpu_torch.infer.quant import Int8Model

            return Int8Model(copy.deepcopy(model).to(dtype))
        raise ValueError(f"unknown serving mode {mode!r}; one of {MODES}")

    results = {}
    for mode in modes:
        summary, miou = evaluate_dataset(
            build(mode), dataset, split.mean, split.std, tile=cfg.crop,
            batch_size=batch, compute_dtype=dtype, device=dev)
        results[mode] = {"miou": round(float(miou), 5), "iou": summary["iou"],
                         "class_names": summary["class_names"]}
        print(json.dumps({"ckpt": ckpt_path, "mode": mode,
                          "miou": results[mode]["miou"]}), flush=True)
    return results


def deltas_vs_standard(results):
    """{mode: {"miou_delta", "worst_class_delta", "worst_class"}} of the
    modes other than ``standard``."""
    base = results.get("standard")
    out = {}
    if base is None:
        return out
    for mode, r in results.items():
        if mode == "standard":
            continue
        per_class = [abs(a - b) for a, b in zip(r["iou"], base["iou"])]
        worst = max(range(len(per_class)), key=lambda i: per_class[i])
        out[mode] = {
            "miou_delta": round(abs(r["miou"] - base["miou"]), 5),
            "worst_class_delta": round(per_class[worst], 5),
            "worst_class": r["class_names"][worst],
        }
    return out


def run_gate(config_path, ckpt_paths, modes=None, batch_size=None,
             calib_batches=2, tolerance=0.005, class_tolerance=0.02,
             test=False, device=None):
    """The gate over ``ckpt_paths`` (``run_pipeline --gate 1`` calls it).
    Returns (ok, report)."""
    from uemda_tpu_torch.config import load_config
    from uemda_tpu_torch.train.loop import build_model

    cfg = load_config(config_path)
    modes = list(modes or MODES)
    if "standard" not in modes:
        # the gate is a comparison: nothing to gate without the baseline,
        # and exiting 0 would read as "quality verified"
        modes = ["standard"] + modes
        print(json.dumps({"note": "added 'standard' baseline to --modes"}))
    model = build_model(cfg, device)
    report, ok = {}, True
    for ckpt in ckpt_paths:
        results = gate_checkpoint(cfg, ckpt, modes, batch_size, calib_batches,
                                  test=test, model=model)
        deltas = deltas_vs_standard(results)
        ckpt_ok = all(d["miou_delta"] <= tolerance
                      and d["worst_class_delta"] <= class_tolerance
                      for d in deltas.values())
        ok = ok and ckpt_ok
        report[ckpt] = {"miou": {m: r["miou"] for m, r in results.items()},
                        "deltas": deltas, "ok": ckpt_ok}
    print("GATE_RESULT " + json.dumps(
        {"report": report, "tolerance": tolerance,
         "class_tolerance": class_tolerance, "ok": ok}), flush=True)
    return ok, report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serving-mode mIoU + per-class IoU gate.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-path", type=str, required=True,
                        help="checkpoint path, or a comma list of several "
                        "(different stages/seeds); every one must pass")
    parser.add_argument("--test", type=str2bool, default=0,
                        help="use TEST split instead of EVAL")
    parser.add_argument("--modes", type=str, default=",".join(MODES),
                        help="comma list of " + ",".join(MODES))
    parser.add_argument("--calib-batches", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--tolerance", type=float, default=0.005,
                        help="max |mIoU - standard| per checkpoint")
    parser.add_argument("--class-tolerance", type=float, default=0.02,
                        help="max per-class |IoU - standard| per checkpoint")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise SystemExit(f"--modes: unknown {unknown}; one of {MODES}")
    ok, _ = run_gate(args.config_path,
                     [p for p in args.ckpt_path.split(",") if p],
                     modes=modes, batch_size=args.batch_size,
                     calib_batches=args.calib_batches,
                     tolerance=args.tolerance,
                     class_tolerance=args.class_tolerance,
                     test=bool(args.test), device=args.device)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()

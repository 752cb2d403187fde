"""The numbers that decide ``correct``, each against its limit.

Training (the reference follows the run's first three steps). Leaves whose
reference gradient is under a thousandth of the median leaf's are nought
to rounding (the pyramid head's pool-1 branch reads the spatial mean of an
instance-normed map, which is zero, so its BatchNorm scales rounding noise
up) and are left out of ``grad``, ``change`` and ``change_median``:

* ``loss``: the largest gap, over the three steps, between the program's
  loss and the reference's, over the reference's;
* ``grad``: the first gradient as the optimizer took it (its momentum
  after step 1, less the weight decay term): the worst leaf's gap between
  the two sides' norms, over the larger of the reference leaf's norm and
  the median leaf's;
* ``change``: the parameters' change over the three steps, by the same
  measure; ``change_median``: the median leaf's gap, steady where the worst
  leaf is not;
* ``protos`` (stage 3): the gap of the prototypes' change, over the
  reference's; ``coral`` (stage 1): the largest gap of the CORAL term over
  the three steps, over the reference's.

Serving: ``gap``, the widest gap by which the probability of a served
pixel's label lies below the reference's best at that pixel, over a sample
of the served requests; or, where the served answer is the probabilities
themselves, the widest difference between the served and the reference
probabilities.
"""

from typing import Dict, List, Optional

import torch

PROTOS = "aligner.prototypes"


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _median(vals) -> float:
    vals = sorted(vals)
    n = len(vals)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    """Each kept leaf's gap of norms over max(its reference norm, the
    median kept leaf's)."""
    g, r = _norms(got), _norms(ref)
    med = _median([r[n] for n in keep])
    return {n: abs(g[n] - r[n]) / max(r[n], med, 1e-30) for n in keep}


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient norm is at least a thousandth
    of the median leaf's."""
    r = _norms(ref_grad)
    med = _median(list(r.values()))
    return [n for n, v in r.items() if v >= 1e-3 * med]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def training_readings(prog: dict, ref: List[dict]) -> Dict[str, float]:
    """``prog``: {'losses': [per step], 'coral': [per step, stage 1],
    'grad': leaves, 'change': leaves (and the prototypes)}; ``ref``:
    :func:`reference.steps.follow`'s records."""
    keep = moved_leaves(ref[0]["grad"])
    change = leaf_gaps(prog["change"], ref[-1]["change"], keep)
    out = {"loss": max(_rel(p, r["loss"])
                       for p, r in zip(prog["losses"], ref)),
           "grad": max(leaf_gaps(prog["grad"], ref[0]["grad"],
                                 keep).values()),
           "change": max(change.values()),
           "change_median": _median(change.values())}
    if PROTOS in ref[-1]["change"]:
        g = _norms({PROTOS: prog["change"][PROTOS]})[PROTOS]
        r = _norms({PROTOS: ref[-1]["change"][PROTOS]})[PROTOS]
        out["protos"] = _rel(g, r)
    if prog.get("coral"):
        out["coral"] = max(_rel(p, q["loss_domain"])
                           for p, q in zip(prog["coral"], ref))
    return out


def worst_leaves(prog: dict, ref: List[dict], n: int = 3) -> dict:
    """The ``n`` kept leaves with the widest gaps of the first gradient and
    of the change: what a look at a high reading starts from."""
    keep = moved_leaves(ref[0]["grad"])
    out = {}
    for key, got, want in (("grad", prog["grad"], ref[0]["grad"]),
                           ("change", prog["change"], ref[-1]["change"])):
        gaps = leaf_gaps(got, want, keep)
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def label_gap(labels: torch.Tensor, ref_probs: torch.Tensor) -> float:
    """Widest gap of the served labels' reference probability below the
    reference's best: labels (H, W) int, ref_probs (C, H, W)."""
    best = ref_probs.amax(0)
    got = torch.gather(ref_probs, 0, labels.long()[None])[0]
    return float((best - got).amax())


def prob_gap(probs: torch.Tensor, ref_probs: torch.Tensor) -> float:
    """Widest difference of served (C, H, W) probabilities from the
    reference's."""
    return float((probs.float() - ref_probs).abs().amax())


def verdict(readings: Dict[str, float], limits: Optional[Dict[str, dict]]):
    """(correct, [(name, reading, limit)]): correct when every number the
    limits name is finite and within its limit (no limits: not correct)."""
    if limits is None:
        return False, [(k, v, None) for k, v in readings.items()]
    rows, ok = [], True
    for name, lim in limits.items():
        val = readings.get(name)
        bad = val is None or not (val == val) or val > lim["limit"]
        ok = ok and not bad
        rows.append((name, val, lim["limit"]))
    return ok, rows

"""Gradient accumulation and PROCA's stage 2 on the CPU: four
``make_align_simple_step`` micro-steps under ``accum_steps`` 2 against the
JAX step under ``optax.MultiSteps``, the optimizer's accumulation alone
against optax's exactly, and a resume in the middle of an accumulation
against the uninterrupted run. The step helpers are
``test_torch_zoo_steps.py``'s."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_zoo_steps import (
    CROP,
    LR,
    NORM,
    C,
    K,
    _batches,
    _jax_sd,
    _no_dropout,
    _states,
    _step_pair,
    _updates_close,
)
from tests.torch_port_helpers import models_from_port
from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from uemda_tpu.train.optim import make_optimizer
from uemda_tpu.train.steps import StageHParams as JaxHParams
from uemda_tpu.train.steps import make_align_simple_step as jax_align_simple
from uemda_tpu_torch.config import PRESETS
from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.models.port import state_dict_from_jax
from uemda_tpu_torch.train.loop import build_state
from uemda_tpu_torch.train.steps import (
    StageHParams,
    make_align_simple_step,
    make_src_step,
)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def test_align_simple_micro_steps_with_accumulation_match_multisteps(
        monkeypatch):
    """Four ``make_align_simple_step`` micro-steps (PROCA's stage 2: CORAL,
    the target label from the heads' averaged softmax at stride 16 gated at
    ``conf_thresh`` 0.3 -- a random model is unsure -- PCL on both
    domains) with ``accum_steps`` 2 against the JAX step under
    ``optax.MultiSteps(every_k_schedule=2)``, f32, dropout off. The losses
    1e-4 relative at every micro-step, the target's PCL term taking part;
    after micro-steps 1 and 3 the masters are exactly the last update's
    (and JAX's after 1 its start) while the BatchNorm statistics move; the
    update count (JAX's ``gradient_step``) and ``mini_step`` follow; the
    running mean of the gradients after micro-step 3 within 0.15 relative
    norm of JAX's ``acc_grads``, zeroed after 4; the prototypes (which move
    every micro-step) within 1e-5 of their largest entry; the updates
    after 4 as ``_updates_close``. The schedule's horizon is the 20
    updates of 40 micro-steps."""
    from uemda_tpu_torch.train.lr import poly_warmup_schedule

    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = models_from_port("resnet18", seed=3)
    proto = np.random.default_rng(4).normal(size=(C, K)).astype(np.float32)
    jstate, state = _states(variables, tmodel, prototypes=proto, accum=2)
    assert state.opt.schedule(5) == poly_warmup_schedule(LR, 20)(5) \
        != poly_warmup_schedule(LR, 40)(5)
    hp = dict(class_num=C, crop=(CROP, CROP), align_domain=True,
              compute_dtype="float32", **NORM)
    jstep = jax_align_simple(jmodel, JaxHParams(**hp), conf_thresh=0.3)
    step = make_align_simple_step(tmodel, StageHParams(**hp), conf_thresh=0.3)
    last = {k: v.clone() for k, v in tmodel.state_dict().items()}
    for i in range(4):
        jstate, jm, tm = _step_pair(jstep, step, jstate, state, 20 + i,
                                    "image", 4, "oneof")
        for k in ("loss", "loss_seg", "loss_align", "loss_domain"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"micro-step {i} {k}")
        assert float(tm["loss_align"]) > 0
        opt = jstate.opt_state
        assert (state.opt.mini_step, state.opt.count) == \
            (int(opt.mini_step), int(opt.gradient_step)) == ((i + 1) % 2,
                                                              (i + 1) // 2)
        sd = tmodel.state_dict()
        if i % 2 == 0:   # accumulated only
            jsd = _jax_sd(jstate)
            for k, t in sd.items():
                if "running" in k:
                    assert not torch.equal(t, last[k]), k
                elif "num_batches" not in k:
                    assert torch.equal(t, last[k]), k
                    if i == 0:
                        assert torch.equal(jsd[k], last[k]), k
        if i == 2:
            acc = state_dict_from_jax({"params": jax.tree.map(
                np.asarray, opt.acc_grads), "batch_stats": jax.tree.map(
                    np.asarray, jstate.batch_stats)})
            names = state.opt.names
            num = sum(float(((a - acc[n]) ** 2).sum())
                      for n, a in zip(names, state.opt.acc))
            den = sum(float((acc[n] ** 2).sum()) for n in names)
            assert den > 0 and np.sqrt(num / den) < 0.15, np.sqrt(num / den)
        last = {k: v.clone() for k, v in sd.items()}
    assert all(float(a.abs().max()) == 0 for a in state.opt.acc)
    assert state.step == int(jstate.step) == 4
    want = np.asarray(jstate.aligner.prototypes)
    np.testing.assert_allclose(state.aligner.prototypes.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    _updates_close(tmodel, jstate, variables)


def test_resume_in_the_middle_of_an_accumulation_is_exact():
    """Stage-1 OHEM micro-steps with ``accum_steps`` 2: one, a snapshot
    (``TrainState.state_dict``, copied as ``torch.save`` would), a fresh
    model and state loaded from it, and a second -- equal, bit for bit, to
    two uninterrupted micro-steps (masters, statistics, momentum, running
    mean, counts), the second applying the update the first began. A
    snapshot without ``mini_step`` is refused by a state that accumulates,
    and a state without accumulation loads the plain part."""
    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                              learning_rate=LR)
    mcfg = DeeplabV2Config.uemda_default(C, resnet_type="resnet18")
    hp = StageHParams(class_num=C, crop=(CROP, CROP), source_loss="ohem",
                      compute_dtype="float32", **NORM)

    base = DeeplabV2(mcfg, device="cpu",
                     generator=torch.Generator().manual_seed(7))

    def fresh(accum=2):
        model = copy.deepcopy(base).train()
        return build_state(model, cfg, 40, feat_channels=K,
                           accum_steps=accum)

    def run(state, steps):
        step = make_src_step(state.model, hp)
        for i in steps:
            img, label, _, _ = _batches(30 + i)
            step(state, {"image": torch.from_numpy(img),
                         "label": torch.from_numpy(label)}, None, 2333)

    whole = fresh()
    run(whole, range(2))
    part = fresh()
    run(part, range(1))
    assert part.opt.mini_step == 1 and part.opt.count == 0
    snap = {k: v for k, v in part.state_dict().items()}
    snap = torch.utils._pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, snap)
    resumed = fresh()
    resumed.load_state_dict(snap)
    run(resumed, [1])
    a, b = whole.state_dict(), resumed.state_dict()
    assert (b["step"], b["opt"]["count"], b["opt"]["mini_step"]) == (2, 1, 0)
    assert (a["step"], a["opt"]["count"], a["opt"]["mini_step"]) == (2, 1, 0)
    for k, t in a["model"].items():
        assert torch.equal(t, b["model"][k]), k
    for part_name in ("trace", "acc"):
        for x, y in zip(a["opt"][part_name], b["opt"][part_name]):
            assert torch.equal(x, y), part_name
    with pytest.raises(KeyError, match="mini_step"):
        bad = dict(snap, opt={k: v for k, v in snap["opt"].items()
                              if k != "mini_step"})
        fresh().load_state_dict(bad)
    plain = fresh(accum=1)
    plain.load_state_dict({**snap, "opt": {"trace": snap["opt"]["trace"],
                                           "count": 0}})
    assert plain.opt.count == 0 and plain.step == 1


@pytest.mark.parametrize("scale", [0.01, 40.0], ids=["unclipped", "clipped"])
def test_sgd_accumulation_matches_optax_multisteps(scale):
    """Six micro-steps of the port's SGD with ``accum_steps`` 3 against
    ``make_optimizer(accum_steps=3)`` (optax.MultiSteps over clip 32 ->
    weight decay -> momentum -> -lr(count), the stem frozen) on the same
    parameters and gradients, the clip inactive and active: after every
    micro-step the parameters, the momentum, the running mean of the
    gradients and the counts (``mini_step``; the update count is
    MultiSteps' ``gradient_step``) agree, rtol 1e-6."""
    import optax

    from uemda_tpu.train.optim import freeze_mask as jax_freeze_mask
    from uemda_tpu_torch.train.optim import SGD, freeze_mask

    r = np.random.default_rng(1)
    shapes = {"encoder.resnet.conv1.weight": (4, 3),
              "encoder.resnet.layer1.0.conv1.weight": (5,),
              "layer5.conv_last.4.bias": (6,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    sched = lambda step: 0.01 * (step + 1)  # noqa: E731

    def nest(flat):
        tree = {}
        for k, v in flat.items():
            node = tree
            for part in k.split(".")[:-1]:
                node = node.setdefault(part, {})
            node[k.split(".")[-1]] = v
        return tree

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = np.asarray(v)
        return out

    jparams = nest({k: jnp.asarray(v) for k, v in p0.items()})
    mask = jax_freeze_mask({"encoder": jparams["encoder"]["resnet"],
                            "layer5": jparams["layer5"]}, 1)
    mask = {"encoder": {"resnet": mask["encoder"]}, "layer5": mask["layer5"]}
    tx = make_optimizer(sched, trainable_mask=mask, accum_steps=3)
    jstate = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    named = list(tparams.items())
    opt = SGD(named, sched, trainable=freeze_mask(named, 1), accum_steps=3)
    for g in grads:
        upd, jstate = tx.update(nest({k: jnp.asarray(v) for k, v in g.items()}),
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        assert (opt.mini_step, opt.count) == (int(jstate.mini_step),
                                               int(jstate.gradient_step))
        want_p, want_acc = flat(jparams), flat(jstate.acc_grads)
        trace = [s for s in jax.tree_util.tree_leaves(
            jstate.inner_opt_state, is_leaf=lambda x: isinstance(
                x, optax.TraceState)) if isinstance(s, optax.TraceState)]
        want_t = flat(trace[0].trace)
        for i, k in enumerate(opt.names):
            np.testing.assert_allclose(tparams[k].numpy(), want_p[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(opt.acc[i].numpy(), want_acc[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(opt.trace[i].numpy(), want_t[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert opt.count == 2 and opt.mini_step == 0
    np.testing.assert_array_equal(tparams["encoder.resnet.conv1.weight"].numpy(),
                                  p0["encoder.resnet.conv1.weight"])

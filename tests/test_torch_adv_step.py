"""The adversarial (G + D) step of the port on the CPU against the JAX
package's ``make_adv_step``: two steps, and one micro-step under gradient
accumulation; D's Adam against ``optax.adam``; ``AdvState``'s snapshot."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_da_modules import flax_disc_params
from tests.test_torch_zoo_steps import (
    C,
    NORM,
    _no_dropout,
    _states,
    _step_pair,
    _updates_close,
)
from tests.torch_port_helpers import models_from_port
from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from uemda_tpu.train.adversarial import AdvState as JaxAdvState
from uemda_tpu.train.adversarial import make_adv_step as jax_make_adv_step
from uemda_tpu.train.steps import StageHParams as JaxHParams
from uemda_tpu_torch.config import PRESETS
from uemda_tpu_torch.train.loop import build_state
from uemda_tpu_torch.train.adversarial import (
    Adam,
    create_adv_state,
    make_adv_step,
)
from uemda_tpu_torch.train.steps import StageHParams

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CROP = 64
D_LR = 1e-4
LAMBDA = 0.1   # the adversarial term well above rounding in the G loss


def _adv_states(variables, tmodel, accum=1):
    """The JAX ``AdvState`` and the port's on the same segmenter and the
    same D (the port's seeded init, carried to flax), each with a fresh
    Adam at ``D_LR``."""
    jstate, state = _states(variables, tmodel, accum=accum)
    adv = create_adv_state(state, C, D_LR)
    d_tx = optax.adam(D_LR, b1=0.9, b2=0.99)
    d_params = flax_disc_params(adv.disc, "fc")
    return JaxAdvState(jstate, d_params, d_tx.init(d_params), d_tx), adv


def _as_flax(tensors):
    """D's tensors in ``named_parameters`` order (a conv's weight, then
    its bias) as flax's ``Conv_i`` tree: OIHW -> HWIO."""
    return {f"Conv_{i}": {"kernel": tensors[2 * i].detach().numpy()
                          .transpose(2, 3, 1, 0),
                          "bias": tensors[2 * i + 1].detach().numpy()}
            for i in range(len(tensors) // 2)}


def _tree_max(tree):
    return max(float(np.abs(np.asarray(w)).max())
               for parts in tree.values() for w in parts.values())


def _tree_close(got, want, what):
    """Within 1e-5 of the largest entry of the whole tree."""
    atol = 1e-5 * _tree_max(want)
    for conv, parts in want.items():
        for part, w in parts.items():
            np.testing.assert_allclose(got[conv][part], np.asarray(w), rtol=0,
                                       atol=atol, err_msg=f"{what} {conv} {part}")


def _record_d_inputs(monkeypatch, adv):
    """The maps each side's D sees, in call order: JAX's through a debug
    callback in ``FCDiscriminator.__call__`` (the order of the D update's
    two calls is the compiler's), the port's through a pre-hook (NHWC)."""
    from uemda_tpu.models import discriminator as j_disc

    got_j, got_t = [], []
    call = j_disc.FCDiscriminator.__call__

    def recorded(self, x):
        jax.debug.callback(lambda v: got_j.append(np.asarray(v)), x)
        return call(self, x)

    monkeypatch.setattr(j_disc.FCDiscriminator, "__call__", recorded)
    adv.disc.register_forward_pre_hook(
        lambda m, args: got_t.append(args[0].detach().permute(0, 2, 3, 1)
                                     .numpy().copy()))
    return got_j, got_t


def _adv_step_pair(jstep, step, jadv, adv, seed, inputs):
    """One step of each. Then D's inputs are held to JAX's (the target map
    of G's pass and the source re-forwarded at the updated G, 1e-4 of
    their max, as G's losses), and D's update to JAX's -- ``d_loss`` and
    ``optax.adam`` from the port's D and Adam state before the step -- on
    the port's own inputs: D's update is held on equal inputs because its
    early layers' gradients are ill-conditioned in the maps (a fresh D
    barely tells source from target, so its two BCE terms nearly
    cancel). The loss 1e-5 relative, the Adam moments within 1e-5 of the
    largest moment (the second through its root, on the gradient's scale
    as the first); the parameters within 1e-5 of the largest parameter,
    except where the new second moment's root is under 100 eps (1e-6):
    there Adam's direction follows the gradient's last bits, and a
    parameter is held within one step, ``D_LR``, of JAX's. JAX's state takes that D for the next step.
    Returns (JAX state, JAX metrics, port metrics)."""
    from uemda_tpu.alignment.extra_losses import bce_logits_loss as j_bce
    from uemda_tpu.models.discriminator import FCDiscriminator as JaxD

    got_j, got_t = inputs
    del got_j[:], got_t[:]
    d_tx = jadv.d_tx
    d_params = jax.tree.map(jnp.asarray, _as_flax(
        [p.detach().clone() for p in adv.disc.parameters()]))
    mu, nu = (jax.tree.map(jnp.asarray, _as_flax([t.clone() for t in ts]))
              for ts in (adv.d_opt.mu, adv.d_opt.nu))
    state = d_tx.init(d_params)
    d_opt = (state[0]._replace(count=jnp.int32(float(adv.d_opt.count)),
                               mu=mu, nu=nu),) + tuple(state[1:])
    jadv, jm, tm = _step_pair(jstep, step, jadv, adv, seed, "none", 4,
                              "oneof")
    assert len(got_j) == len(got_t) == 3
    soft_t, soft_s = got_t[0], got_t[1]
    np.testing.assert_array_equal(got_t[2], soft_t)
    j_t = got_j[0]
    j_s = got_j[2] if np.array_equal(got_j[1], j_t) else got_j[1]
    # the source map at the updated G within 1e-4 where the step's rate
    # was 0 (G unmoved), else within 1e-2: the two G updates differ as
    # ``_updates_close`` allows
    moved = float(adv.opt.lr) > 0 and adv.opt.mini_step == 0
    for what, g, w, tol in (
            ("target map", soft_t, j_t, 1e-4),
            ("source map at the updated G", soft_s, j_s,
             1e-2 if moved else 1e-4)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=what)

    def d_loss(p):
        out_s = JaxD().apply({"params": p}, jnp.asarray(soft_s))
        out_t = JaxD().apply({"params": p}, jnp.asarray(soft_t))
        return 0.5 * (j_bce(out_s, jnp.ones_like(out_s))
                      + j_bce(out_t, jnp.zeros_like(out_t)))

    ld, grads = jax.value_and_grad(d_loss)(d_params)
    np.testing.assert_allclose(float(tm["loss_d"]), float(ld), rtol=1e-5)
    upd, d_opt = d_tx.update(grads, d_opt, d_params)
    d_params = optax.apply_updates(d_params, upd)
    adam = d_opt[0]
    _tree_close(_as_flax(adv.d_opt.mu), adam.mu, "D's Adam mu")
    _tree_close(jax.tree.map(np.sqrt, _as_flax(adv.d_opt.nu)),
                jax.tree.map(jnp.sqrt, adam.nu), "root of D's Adam nu")
    assert float(adv.d_opt.count) == int(adam.count)
    got = _as_flax(list(adv.disc.parameters()))
    bc2 = 1 - 0.99 ** int(adam.count)
    atol = 1e-5 * _tree_max(d_params)
    for conv, parts in d_params.items():
        for part, w in parts.items():
            w = np.asarray(w)
            root = np.sqrt(np.asarray(adam.nu[conv][part]) / bc2)
            tol = np.where(root < 1e-6, D_LR, atol)
            diff = np.abs(got[conv][part] - w)
            assert (diff <= tol).all(), (
                f"D {conv} {part}: {int((diff > tol).sum())} of {w.size} "
                f"off by up to {diff.max():.3g}")
    return jadv.replace(d_params=d_params, d_opt=d_opt), jm, tm


def test_two_adv_steps_match_jax(monkeypatch):
    """Two G + D steps from the same segmenter, D, batches and
    augmentation draws (both domains "oneof", label-free target), dropout
    off on both sides: resnet18, 72^2 uint8 tiles cropped to 64^2, batch
    2, f32, lambda_adv 0.1. G's and D's losses 1e-4 relative; D's inputs,
    D and its Adam moments as ``_adv_step_pair`` holds them (so G's
    backward left no gradient on D that its update would see); the
    segmenter's updates and BatchNorm statistics as ``_updates_close``
    (so the D pass's re-forward left the statistics alone)."""
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = models_from_port("resnet18", seed=2)
    jadv, adv = _adv_states(variables, tmodel)
    inputs = _record_d_inputs(monkeypatch, adv)
    hp = dict(class_num=C, crop=(CROP, CROP), compute_dtype="float32", **NORM)
    jstep = jax_make_adv_step(jmodel, JaxHParams(**hp), lambda_adv=LAMBDA)
    step = make_adv_step(tmodel, StageHParams(**hp), lambda_adv=LAMBDA)
    for i in range(2):
        jadv, jm, tm = _adv_step_pair(jstep, step, jadv, adv, 10 + i, inputs)
        assert sorted(tm) == sorted(jm) == ["loss", "loss_adv", "loss_d",
                                            "loss_seg"]
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        assert float(tm["loss_adv"]) > 0.1 and float(tm["loss_d"]) > 0.1
    assert adv.step == int(jadv.seg.step) == 2
    _updates_close(tmodel, jadv.seg, variables)


def test_adv_step_under_accumulation_matches_jax(monkeypatch):
    """One micro-step with ``accum_steps`` 2: the segmenter's masters stay
    (optax.MultiSteps holds the update), its running mean holds the
    gradient, and D takes its Adam step all the same, as JAX's."""
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = models_from_port("resnet18", seed=2)
    jadv, adv = _adv_states(variables, tmodel, accum=2)
    inputs = _record_d_inputs(monkeypatch, adv)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()
              if "running" not in k and "num_batches" not in k}
    hp = dict(class_num=C, crop=(CROP, CROP), compute_dtype="float32", **NORM)
    jstep = jax_make_adv_step(jmodel, JaxHParams(**hp), lambda_adv=LAMBDA)
    step = make_adv_step(tmodel, StageHParams(**hp), lambda_adv=LAMBDA)
    jadv, jm, tm = _adv_step_pair(jstep, step, jadv, adv, 12, inputs)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    for k, v in before.items():
        assert torch.equal(tmodel.state_dict()[k], v), k
    assert adv.opt.count == 0 and adv.opt.mini_step == 1
    assert int(jadv.seg.opt_state.mini_step) == 1
    assert float(adv.opt.acc[0].abs().max()) > 0
    assert float(adv.d_opt.count) == 1


def test_adam_matches_optax_and_the_adv_state_round_trips():
    """The port's Adam against ``optax.adam(lr, b1=0.9, b2=0.99)`` over
    five updates of random gradients (1e-6 relative); ``AdvState``'s
    ``state_dict`` into a fresh state copies every tensor of the
    segmenter, D and D's Adam, and a mismatching snapshot raises before
    anything is written."""
    r = np.random.default_rng(0)
    w = torch.nn.Parameter(torch.from_numpy(r.normal(size=(3, 4))
                                            .astype(np.float32)))
    opt = Adam([("w", w)], 1e-2, 0.9, 0.99)
    tx = optax.adam(1e-2, b1=0.9, b2=0.99)
    jw = jnp.asarray(w.detach().numpy().copy())
    js = tx.init(jw)
    for _ in range(5):
        g = (r.normal(size=(3, 4)) * r.choice([1e-3, 1.0])).astype(np.float32)
        w.grad = torch.from_numpy(g.copy())
        opt.update()
        u, js = tx.update(jnp.asarray(g), js, jw)
        jw = optax.apply_updates(jw, u)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                                   rtol=1e-6, atol=1e-7)
    cfg = dataclasses.replace(PRESETS["2vaihingen"], model="resnet18")
    a = create_adv_state(build_state(models_from_port("resnet18", seed=2)[2],
                                     cfg, 10), C)
    a.d_opt.count.fill_(3.0)
    for t in a.d_opt.mu + a.d_opt.nu:
        t.normal_()
    a.seg.step = 7
    b = create_adv_state(build_state(models_from_port("resnet18", seed=5)[2],
                                     cfg, 10), C, seed=1)
    sd = a.state_dict()
    bad = dict(sd, d_opt=dict(sd["d_opt"], mu=sd["d_opt"]["mu"][:-1]))
    b_before = b.disc.state_dict()["classifier.weight"].clone()
    with pytest.raises(ValueError, match="d_opt.mu"):
        b.load_state_dict(bad)
    assert torch.equal(b.disc.state_dict()["classifier.weight"], b_before)
    b.load_state_dict(sd)
    assert b.step == 7 and float(b.d_opt.count) == 3.0
    for x, y in zip(a.d_opt.mu + a.d_opt.nu + list(a.disc.parameters())
                    + list(a.model.parameters()),
                    b.d_opt.mu + b.d_opt.nu + list(b.disc.parameters())
                    + list(b.model.parameters())):
        assert torch.equal(x, y)

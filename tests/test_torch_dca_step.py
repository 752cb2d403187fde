"""The DCA self-training step of the port on the CPU against the JAX
package's ``make_dca_step``, without and with the source class balance
(which both domains read from the step's start, ``steps.py:513-514``)."""

import numpy as np
import pytest

from tests.test_torch_zoo_steps import (
    C,
    CROP,
    NORM,
    _no_dropout,
    _states,
    _step_pair,
    _updates_close,
)
from tests.torch_port_helpers import models_from_port
from tests.torch_port_helpers import one_cpu_thread  # noqa: F401 (fixture)
from uemda_tpu.train.steps import StageHParams as JaxHParams
from uemda_tpu.train.steps import make_dca_step as jax_make_dca_step
from uemda_tpu_torch.train.steps import StageHParams, make_dca_step

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


@pytest.mark.parametrize("bcs", [False, True])
def test_two_dca_steps_match_jax(bcs, monkeypatch):
    """Two DCA steps from the same weights, batches and augmentation draws
    (source "oneof", target "compose" with the clamp; the target's hard
    label ``pseudo_selection`` of its stored soft label), dropout off on
    both sides: resnet18, 72^2 uint8 tiles cropped to 64^2, batch 2, f32.
    The losses (the segmentation sum, ICR and CCR) 1e-4 relative; with
    ``balance_source`` the source balance 1e-6 relative to JAX's -- moved
    by the source labels only -- while the target's pixel weights read the
    balance the step started with; the updates and statistics as
    ``_updates_close``."""
    _no_dropout(monkeypatch)
    jmodel, variables, tmodel = models_from_port("resnet18", seed=2)
    jstate, state = _states(variables, tmodel)
    hp = dict(class_num=C, crop=(CROP, CROP), compute_dtype="float32",
              balance_source=bcs, clamp_target=True, **NORM)
    jstep = jax_make_dca_step(jmodel, JaxHParams(**hp))
    step = make_dca_step(tmodel, StageHParams(**hp))
    for i in range(2):
        jstate, jm, tm = _step_pair(jstep, step, jstate, state, 20 + i, "prob",
                                    4, "compose")
        assert sorted(tm) == sorted(jm) == ["loss", "loss_ccr", "loss_icr",
                                            "loss_seg"]
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        assert float(tm["loss_icr"]) > 0 and float(tm["loss_ccr"]) > 0
    freq = state.balance_s.freq.numpy()
    np.testing.assert_allclose(freq, np.asarray(jstate.balance_s.freq),
                               rtol=1e-6)
    assert np.allclose(freq, 1.0 / C) != bcs
    np.testing.assert_array_equal(state.balance_t.freq.numpy(),
                                  np.full(C, 1.0 / C, np.float32))
    assert state.step == int(jstate.step) == 2
    _updates_close(tmodel, jstate, variables)

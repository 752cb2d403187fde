"""The plain reference against the port at tiny sizes on the CPU, in f32:
the eval forward, slide + TTA through the port's predictor (standard and
fast path), and three train steps of each stage through the harness's own
drivers, whose readings are the program's gaps from the reference."""

import pytest
import torch

from bench_helpers import one_thread, tiny_context
from benchmark.drivers.common import pair_config
from benchmark.harness import make
from benchmark.reference import model as ref_model, serve as ref_serve


@pytest.fixture(scope="module")
def port_model():
    from uemda_tpu_torch.train.loop import build_model

    one_thread()
    ctx = tiny_context("vaihingen.single_fast_tta")
    cfg = pair_config(ctx.config)
    w = make.weights(ref_model.param_spec("resnet18", cfg.class_num), 5,
                     "cpu")
    model = build_model(cfg, "cpu")
    model.load_state_dict(w)
    return model.eval(), w, cfg


def test_eval_forward_equals_the_port(port_model):
    model, w, _ = port_model
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        got = model(x)
    want = ref_model.Net(w, "resnet18").eval_probs(x)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("fastpath", [False, True])
def test_slide_tta_equals_the_port_predictor(port_model, fastpath):
    from uemda_tpu_torch.datasets.augment import normalize
    from uemda_tpu_torch.infer.quant import serving_model
    from uemda_tpu_torch.infer.slide import make_predictor

    model, w, cfg = port_model
    img = make.pool(1, 128, cfg.class_num, 9, 1, "cpu")["image"][0]
    img = torch.from_numpy(img)
    net = serving_model(model, fastpath, False, torch.float32)
    pred = make_predictor(net, (64, 64), (128, 128), tta=True,
                          compute_dtype=torch.float32, capture=False)
    x = normalize(img[None].permute(0, 3, 1, 2), cfg.val.mean, cfg.val.std)
    got = pred(x)[0]
    want = ref_serve.slide_tta(ref_model.Net(w, "resnet18"), img,
                               cfg.val.mean, cfg.val.std, (64, 64))
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("cell", ["urban.ssl_uem", "vaihingen.src"])
def test_train_steps_equal_the_port_in_f32(cell):
    from benchmark.drivers import train

    one_thread()
    res = train.run(tiny_context(cell, dtype="float32"))
    r = res["readings"]
    assert r["loss"] < 1e-5
    assert r["change_median"] < 1e-3
    assert r["grad"] < 2e-2 and r["change"] < 2e-2
    assert r.get("protos", 0.0) < 1e-4 and r.get("coral", 0.0) < 1e-4

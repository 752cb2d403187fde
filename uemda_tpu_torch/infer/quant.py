"""int8 serving of the standard eval forward: every convolution of a model
runs as an int8 x int8 -> int32 product without touching the model's code.

Port of ``uemda_tpu/infer/quant.py``:

* weights: symmetric per-out-channel scales (abs-max / 127) from the
  module's weights, quantized when the wrapper is made;
* activations: a dynamic symmetric scale per sample (abs-max over C, H and
  W / 127), so no calibration set is needed;
* the product accumulates in int32 (``infer.fastpath.int8_conv2d``:
  ``torch._int_mm`` on an int8 im2col, cuBLASLt on the card) and is
  dequantized as ``acc * (sx * sw[c])`` in f32; the bias is added in f32
  and the result cast to the input dtype.

Zero padding is exact under symmetric quantization (zero point 0), so each
conv keeps its stride, padding, dilation and groups. :class:`Int8Model`
wraps an eval-mode ``DeeplabV2`` so it drops into ``make_predictor``,
``evaluate_dataset`` and the eval CLI unchanged.
"""

import contextlib
from typing import Any, Dict

import torch
import torch.nn as nn

from uemda_tpu_torch.infer.fastpath import _quantize_sym, int8_conv2d


def _int8_conv(m: nn.Conv2d, wq: torch.Tensor, sw: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` with int8 inputs and weights and an int32 accumulator."""
    xq, sx = _quantize_sym(x.float(), (1, 2, 3))
    acc = int8_conv2d(xq, wq, m.stride, m.padding, m.dilation, m.groups)
    y = acc.float() * (sx.view(-1, 1, 1, 1) * sw.view(1, -1, 1, 1))
    if m.bias is not None:
        y = y + m.bias.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


class Int8Model:
    """Wraps an eval-mode model: calling it runs the model with every
    ``nn.Conv2d`` rerouted through the int8 conv. The weights are quantized
    when the wrapper is made (serving weights are frozen). Other attributes
    are the model's."""

    def __init__(self, model: nn.Module):
        self.model = model
        self._q: Dict[nn.Conv2d, Any] = {}
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                if isinstance(m.padding, str) or m.padding_mode != "zeros":
                    raise ValueError(f"Int8Model: conv padding {m.padding!r} "
                                     f"({m.padding_mode}) is not supported")
                wq, sw = _quantize_sym(m.weight.detach().float(), (1, 2, 3))
                self._q[m] = (wq, sw.reshape(-1))

    def __getattr__(self, name):
        return getattr(self.model, name)

    @contextlib.contextmanager
    def _rerouted(self):
        try:
            for m, (wq, sw) in self._q.items():
                m.forward = (lambda x, m=m, wq=wq, sw=sw:
                             _int8_conv(m, wq, sw, x))
            yield
        finally:
            for m in self._q:
                m.__dict__.pop("forward", None)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, *args, **kwargs):
        if self.model.training:
            raise ValueError(
                "Int8Model is inference-only: gradients through the rounded "
                "int8 weights are zero -- train with the f32/bf16 model")
        with self._rerouted():
            return self.model(x, *args, **kwargs)


def int8_apply(model: nn.Module, x: torch.Tensor, *args, **kwargs):
    """Functional form of :class:`Int8Model`."""
    return Int8Model(model)(x, *args, **kwargs)

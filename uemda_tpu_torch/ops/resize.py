"""Bilinear resize and adaptive average pooling as separable matrices.

Port of ``uemda_tpu/ops/resize.py``. The reference uses
``F.interpolate(mode='bilinear')`` with ``align_corners=True`` for logits
and ``False`` inside the PPM head (``Encoder.py:48-51``), and
``nn.AdaptiveAvgPool2d`` for the PPM scales. Here, as in the JAX package,
each is a static (out, in) matrix per axis applied in f32; the matrices are
also the building blocks of the fast path's restructured PPM branch
(``infer/fastpath._ppm_pooled_heads``). Layout: NCHW.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense 1-D bilinear interpolation matrix M with y = M @ x, equal to
    F.interpolate(mode='bilinear') for both align_corners settings."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 and align_corners:
        m[0, 0] = 1.0
        return m
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / max(out_size - 1, 1)
        else:
            src = (i + 0.5) * in_size / out_size - 0.5
            src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


@functools.lru_cache(maxsize=128)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense 1-D adaptive average pooling matrix (AdaptiveAvgPool2d bins:
    bin i covers [floor(i*H/s), ceil((i+1)*H/s)))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -(-((i + 1) * in_size) // out_size)  # ceil
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


@functools.lru_cache(maxsize=128)
def matrix_on(device: torch.device, make, *args,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``make(*args)`` (a cached numpy matrix) as a tensor on ``device``,
    copied there once per (device, args, dtype)."""
    return torch.from_numpy(make(*args)).to(device=device, dtype=dtype)


def _apply_separable(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor
                     ) -> torch.Tensor:
    """Apply (H_out, H_in) then (W_out, W_in) to (B, C, H, W) in f32."""
    y = torch.einsum("bchw,oh->bcow", x.float(), mh)
    y = torch.einsum("bchw,ow->bcho", y, mw)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = True
                    ) -> torch.Tensor:
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    h_in, w_in = x.shape[2], x.shape[3]
    if (h_in, w_in) == (h_out, w_out):
        return x
    return _apply_separable(
        x, matrix_on(x.device, _interp_matrix, h_in, h_out, align_corners),
        matrix_on(x.device, _interp_matrix, w_in, w_out, align_corners))


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    if isinstance(out_hw, int):
        out_hw = (out_hw, out_hw)
    h_in, w_in = x.shape[2], x.shape[3]
    return _apply_separable(
        x, matrix_on(x.device, _adaptive_avg_matrix, h_in, int(out_hw[0])),
        matrix_on(x.device, _adaptive_avg_matrix, w_in, int(out_hw[1])))


@functools.lru_cache(maxsize=32)
def _multi_pool_matrix(h_in: int, w_in: int, scales: tuple):
    """(sum_s s^2, h_in*w_in) 0/1 bin-indicator matrix, the (sum_s s^2,)
    reciprocal bin sizes and the per-scale row offsets, for every pyramid
    scale at once."""
    rows = sum(s * s for s in scales)
    n = np.zeros((rows, h_in, w_in), np.float32)
    dinv = np.zeros((rows,), np.float32)
    offs, off = [], 0
    for s in scales:
        for sh in range(s):
            hlo, hhi = (sh * h_in) // s, -(-((sh + 1) * h_in) // s)
            for sw in range(s):
                wlo, whi = (sw * w_in) // s, -(-((sw + 1) * w_in) // s)
                r = off + sh * s + sw
                n[r, hlo:hhi, wlo:whi] = 1.0
                dinv[r] = 1.0 / ((hhi - hlo) * (whi - wlo))
        offs.append(off)
        off += s * s
    return n.reshape(rows, h_in * w_in), dinv, tuple(offs)


def _multi_pool_indicator(h_in: int, w_in: int, scales: tuple) -> np.ndarray:
    return _multi_pool_matrix(h_in, w_in, scales)[0]


def _multi_pool_dinv(h_in: int, w_in: int, scales: tuple) -> np.ndarray:
    return _multi_pool_matrix(h_in, w_in, scales)[1]


def adaptive_avg_pool_multi(x: torch.Tensor, scales) -> dict:
    """All PPM pyramid scales from one read of ``x``: one indicator GEMM in
    f32 over the (B, H*W, C) view of the channels_last map, then the
    1/count scale. Returns {scale: (B, C, s, s)} in x's dtype."""
    scales = tuple(int(s) for s in scales)
    b, c, h_in, w_in = x.shape
    offs = _multi_pool_matrix(h_in, w_in, scales)[2]
    n = matrix_on(x.device, _multi_pool_indicator, h_in, w_in, scales)
    dinv = matrix_on(x.device, _multi_pool_dinv, h_in, w_in, scales)
    xv = x.permute(0, 2, 3, 1).reshape(b, h_in * w_in, c).float()
    t = torch.matmul(n, xv) * dinv[None, :, None]   # (b, P, c)
    return {
        s: t[:, off:off + s * s].reshape(b, s, s, c).permute(0, 3, 1, 2)
        .to(x.dtype).contiguous(memory_format=torch.channels_last)
        for s, off in zip(scales, offs)
    }


def upsample_logits(logits: torch.Tensor, out_hw) -> torch.Tensor:
    """Head-logit upsampling: bilinear, align_corners=True (reference
    ``Encoder.py:141-142`` / ``tools.py:249-250``;
    ``uemda_tpu/ops/resize.py:154-157``)."""
    return resize_bilinear(logits, out_hw, align_corners=True)

"""PyTorch + CUDA port of ``uemda_tpu`` for NVIDIA Hopper (H100).

The JAX package ``uemda_tpu`` is the reference and stays as it is; this
package mirrors its module names. It imports ``torch`` and numpy, never
``jax``, ``flax`` or anything of ``uemda_tpu``. Tensors are NCHW in logical
order and channels_last in memory. Entry points run on the card unless the
caller passes ``device="cpu"``; each TPU Pallas kernel on the ported path is
a hand-written CUDA kernel under ``kernels/csrc/`` with a plain PyTorch
version beside it in ``ops/``.
"""

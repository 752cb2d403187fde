"""Bytes and operations one launch of each of the port's kernels needs,
from its shapes: each input read once and each output written once,
whatever the kernel reads again; operations where they bound the launch.
A launch's roofline time is the larger of its operations at the bf16 peak
and its bytes at the memory bandwidth (``harness/device.py``).

Each function takes the launch's shapes and element sizes and returns
``(operations, bytes)``; ``kernel_patterns`` names each kernel's device
functions as the profiler shows them.
"""

from typing import Dict, Tuple

# device function names of each kernel (K5's table fill runs with it)
KERNEL_PATTERNS: Dict[str, Tuple[str, ...]] = {
    "k1": ("instance_norm_kernel",),
    "k1_bwd": ("instance_norm_backward_kernel",),
    "k2": ("stem_pool_mma", "stem_pool_fma"),
    "k3": ("tail_kernel",),
    "k5": ("segment_reduce_kernel", "fill_kernel"),
    "k7": ("segment_gather_kernel",),
    "k8": ("uvem_mine_stats", "uvem_mine_select"),
    "k9": ("crop_normalize_kernel",),
}

# device functions one launch runs (K5: the table fill and the reduction;
# K8: its two passes); one for the others
EVENTS_PER_LAUNCH = {"k5": 2, "k8": 2}

# the wrapper whose ``launches`` counts each kernel's launches
WRAPPERS = {"k1": "instance_norm", "k1_bwd": "instance_norm_backward",
            "k2": "stem_pool", "k3": "tail_upsample_softmax_mean",
            "k5": "segment_max", "k7": "segment_gather", "k8": "uvem_mine",
            "k9": "crop_normalize"}


def k1(b, c, h, w, elem=2):
    """Instance norm forward: x in, y out, f32 mean and rstd out."""
    n = b * c * h * w
    return 4 * n, 2 * n * elem + 2 * b * c * 4


def k1_bwd(b, c, h, w, elem=2):
    """Its backward: x, dy, mean and rstd in, dx out."""
    n = b * c * h * w
    return 8 * n, 3 * n * elem + 2 * b * c * 4


def k2(b, h, w, elem=2):
    """The fast path's stem: the 7x7/2 conv (3 -> 64) + bias + ReLU +
    3x3/2 max-pool of (b, 3, h, w), the pooled map out; the operations of
    the 7x7 conv."""
    oh, ow = -(-h // 2), -(-w // 2)
    ph, pw = -(-oh // 2), -(-ow // 2)
    ops = 2 * b * 64 * 3 * 49 * oh * ow
    return ops, b * 3 * h * w * elem + b * 64 * ph * pw * elem \
        + 64 * 3 * 49 * elem + 64 * 4


def k3(b, heads, nc, hi, wi, ho, wo, elem=2):
    """The eval tail: heads' logits (b, heads * nc, hi, wi) in, the mean
    of their softmax upsampled to (ho, wo) out."""
    ops = b * heads * nc * ho * wo * 8
    return ops, b * heads * nc * hi * wi * elem + b * nc * ho * wo * elem


def k5(b, n, c, s):
    """Segment max: (b, n, c) f32 and (b, n) int32 ids in, (b, s, c) f32
    out."""
    return b * n * c, b * n * c * 4 + b * n * 4 + b * s * c * 4


def k7(b, n, c, s):
    """Segment gather: (b, s, c) f32 and ids in, (b, n, c) f32 out."""
    return 0, b * s * c * 4 + b * n * 4 + b * n * c * 4


def k8(b, c, h, w):
    """Mining: (b, c, h, w) f32 in; label, weight, entropy out."""
    return 10 * b * c * h * w, b * c * h * w * 4 + 3 * b * h * w * 4


def k9(b, th, tw):
    """Crop + normalize: the (b, th, tw, 3) uint8 windows in, f32 out."""
    return 2 * b * th * tw * 3, b * th * tw * 3 + b * 3 * th * tw * 4


COUNTS = {"k1": k1, "k1_bwd": k1_bwd, "k2": k2, "k3": k3, "k5": k5,
          "k7": k7, "k8": k8, "k9": k9}

"""Typed model configuration (a copy of ``uemda_tpu/models/config.py``).

Replaces the reference's ever-style config dicts (``uemda/models/Encoder.py:
167-186``, ``uemda/resnet.py:170-181``) with frozen dataclasses. The same
knobs exist: resnet type, output stride, BN freezing, stage freezing,
per-stage gradient checkpointing, dual heads, PPM vs ASPP, cascade heads and
instance norm.
"""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    resnet_type: str = "resnet50"
    output_stride: int = 16  # 8, 16 or 32 (resnet.py:48-51)
    # path to ImageNet backbone weights; None = He init. The reference
    # downloads torchvision weights at runtime (_resnets.py:230-238).
    pretrained: Optional[str] = None
    batchnorm_trainable: bool = True  # False = frozen BN (resnet.py:112-117)
    freeze_at: int = 0  # 0..5, freeze stem/layers (resnet.py:119-130)
    with_cp: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    include_conv5: bool = True

    def __post_init__(self):
        if self.output_stride not in (8, 16, 32):
            raise ValueError("output_stride must be 8, 16 or 32.")


@dataclasses.dataclass(frozen=True)
class PPMConfig:
    num_classes: int = 7
    fc_dim: int = 2048
    use_aux: bool = False
    pool_scales: Tuple[int, ...] = (1, 2, 3, 6)


@dataclasses.dataclass(frozen=True)
class DeeplabV2Config:
    backbone: BackboneConfig = BackboneConfig()
    multi_layer: bool = True
    cascade: bool = False
    use_ppm: bool = True
    ppm: PPMConfig = PPMConfig()
    inchannels: int = 2048
    num_classes: int = 7
    is_ins_norm: bool = True
    # ASPP head dilations (Encoder.py:98-116)
    aspp_dilations: Tuple[int, ...] = (6, 12, 18, 24)

    @staticmethod
    def uemda_default(num_classes: int, resnet_type: str = "resnet50",
                      pretrained: Optional[str] = None) -> "DeeplabV2Config":
        """The single config every reference tool instantiates
        (tools/train_src.py:63-80)."""
        return DeeplabV2Config(
            backbone=BackboneConfig(
                resnet_type=resnet_type, output_stride=16, pretrained=pretrained
            ),
            multi_layer=True,
            cascade=False,
            use_ppm=True,
            ppm=PPMConfig(num_classes=num_classes, fc_dim=2048, use_aux=False),
            inchannels=2048,
            num_classes=num_classes,
            is_ins_norm=True,
        )

from uemda_tpu_torch.models.config import BackboneConfig, DeeplabV2Config, PPMConfig
from uemda_tpu_torch.models.deeplabv2 import DeeplabV2

__all__ = ["BackboneConfig", "DeeplabV2", "DeeplabV2Config", "PPMConfig"]

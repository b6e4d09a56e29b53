"""Appearance embeddings (ReID): crops on the card (kernel K5) and the OSNet
backbones, behind the reference's ``get_features`` contract."""

from boxmot_tpu_torch.reid.backends import create_reid
from boxmot_tpu_torch.reid.core import ReID

__all__ = ["ReID", "create_reid"]

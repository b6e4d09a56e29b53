"""Appearance embeddings (ReID): crops on the card (kernel K5) and every
backbone of the JAX package, behind the reference's ``get_features``
contract; ``reid.training`` trains them (``ReIDTrainer``) and CLIP-ReID's
identity prompts."""

from boxmot_tpu_torch.reid.backends import create_reid
from boxmot_tpu_torch.reid.core import ReID

__all__ = ["ReID", "create_reid"]

"""Appearance embeddings (ReID): crops on the card (kernel K5) and every
backbone of the JAX package, behind the reference's ``get_features``
contract; ``reid.training`` trains them (``ReIDTrainer``) and CLIP-ReID's
identity prompts.  ``MODEL_FACTORY`` names every backbone's builder;
``TFLiteReID`` and ``SavedModelReID`` serve exported artifacts."""

from boxmot_tpu_torch.reid.backends import SavedModelReID, TFLiteReID, create_reid
from boxmot_tpu_torch.reid.core import MODEL_FACTORY, ReID

__all__ = ["MODEL_FACTORY", "ReID", "SavedModelReID", "TFLiteReID", "create_reid"]

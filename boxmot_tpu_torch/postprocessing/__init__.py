"""A copy of ``boxmot_tpu/postprocessing/__init__.py``.

Offline postprocessing over MOT result files.

Mirror of boxmot/postprocessing/__init__.py:1-10: registry of
postprocessors chained via names like "gsi,gbrc".
"""

from boxmot_tpu_torch.postprocessing.base import MotFilePostprocessor, Postprocessor  # noqa: F401
from boxmot_tpu_torch.postprocessing.registry import (  # noqa: F401
    create_postprocessor,
    supported_postprocessors,
)

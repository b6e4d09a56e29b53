"""The ReID facade: boxes of a frame -> L2-normalized appearance embeddings.

Counterpart of ``boxmot_tpu/reid/core.py`` (``ReID``, ``infer_model_name``,
``get_features``, ``get_features_multi``, ``half``).  A call uploads the
uint8 frame once, cuts and standardizes the crops with kernel K5
(``ops/crops.py::extract_crops``, one launch per chunk of at most 256 crops)
and runs the backbone on them; the features stay on the device
(``features``), and ``get_features`` returns them as numpy, the reference's
contract.  The JAX package pads a call's crops to a static bucket for
XLA's compile cache; eager PyTorch needs none, so a crop's feature is the
same, within the backbone's rounding, alone or in any batch.

Backbones (``MODEL_BUILDERS``), every name of the JAX ``MODEL_FACTORY``:
the OSNet family (``models/osnet.py``), the ViTs (``models/vit.py``: six
variants), CSL-TinyViT (``models/csl_tinyvit.py``: ten variants and
aliases), LMBN and LMBN-AIN (``models/lmbn.py``), CSPReID-n, MLFN, HACNN
(which takes 160 x 64 crops: the default ``crop_hw`` of (256, 128) fails its
assertion, as in the JAX package), CLIP-ReID's image encoder
(``models/clip_reid.py``), ResNet-50/101 and MobileNetV2 x1.0/x1.4
(``models/backbones.py``).  The ViTs and CLIP size their positional
embeddings from the crop, as Flax does at ``init``, so ``build_model``
takes ``crop_hw``.  ``MODEL_NAMES`` keeps the JAX ``MODEL_FACTORY``'s names
in its order, so ``infer_model_name`` resolves a weights file exactly as
the JAX package does.  Checkpoints convert for OSNet and CLIP
(``models/convert.py``); any other backbone's raises the JAX package's
``ValueError``.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from boxmot_tpu_torch.models import convert as convert_mod
from boxmot_tpu_torch.models.backbones import build_mobilenetv2, build_resnet50, build_resnet101
from boxmot_tpu_torch.models.clip_reid import build_clip_reid
from boxmot_tpu_torch.models.csl_tinyvit import build_csl_tinyvit
from boxmot_tpu_torch.models.cspreid import build_cspreid
from boxmot_tpu_torch.models.hacnn import build_hacnn
from boxmot_tpu_torch.models.lmbn import build_lmbn
from boxmot_tpu_torch.models.mlfn import build_mlfn
from boxmot_tpu_torch.models.osnet import OSNET_VARIANTS, build_osnet
from boxmot_tpu_torch.models.vit import build_vit
from boxmot_tpu_torch.ops.crops import as_frame, extract_crops
from boxmot_tpu_torch.utils.device import resolve_device

CHUNK = 256  # the most crops one backbone call takes (the JAX CROP_BUCKETS' largest)

# the JAX MODEL_FACTORY's names, in its order (boxmot_tpu/reid/core.py:42-87)
CSL_VARIANTS = (
    "csl_tinyvit_7m", "csl_tinyvit_7m_lmbn", "csl_tinyvit_11m", "csl_tinyvit_11m_lmbn",
    "csl_tinyvit_23m", "csl_tinyvit_23m_lmbn", "csl_tinyvit_small", "csl_tinyvit_normal",
    "csl_tinyvit_large", "csl_tinyvit_lmbn",
)
VIT_VARIANTS = ("vit_nano", "vit_nano_ain", "vit_nano_ain_os", "vit_tiny", "vit_tiny_parts",
                "vit_tiny_parts3")
MODEL_NAMES = (*OSNET_VARIANTS, *VIT_VARIANTS, *CSL_VARIANTS, "lmbn_n", "lmbn_ain_n",
               "cspreid_n", "mlfn", "hacnn", "clip", "resnet50", "resnet101", "mobilenetv2_x1_0",
               "mobilenetv2_x1_4", "mobilenetv2")
# the JAX MODEL_FACTORY's builders, by name
MODEL_BUILDERS = {
    **{name: partial(build_osnet, name) for name in OSNET_VARIANTS},
    **{name: partial(build_vit, name) for name in VIT_VARIANTS},
    **{name: partial(build_csl_tinyvit, name) for name in CSL_VARIANTS},
    "lmbn_n": partial(build_lmbn, "lmbn_n"),
    "lmbn_ain_n": partial(build_lmbn, "lmbn_ain_n"),
    "cspreid_n": build_cspreid,
    "mlfn": build_mlfn,
    "hacnn": build_hacnn,
    "clip": build_clip_reid,
    "resnet50": build_resnet50,
    "resnet101": build_resnet101,
    "mobilenetv2_x1_0": build_mobilenetv2,
    "mobilenetv2_x1_4": partial(build_mobilenetv2, width=1.4),
    "mobilenetv2": build_mobilenetv2,
}
CROP_SIZED = (*VIT_VARIANTS, "clip")  # positional embeddings sized from the crop


def build_model(name: str, crop_hw=(256, 128)) -> torch.nn.Module:
    """Backbone ``name`` of ``MODEL_NAMES`` for ``crop_hw`` crops, with
    PyTorch's default initialization."""
    if name not in MODEL_BUILDERS:
        raise KeyError(f"unknown ReID model {name!r}")
    if name in CROP_SIZED:
        return MODEL_BUILDERS[name](crop_hw=tuple(crop_hw))
    return MODEL_BUILDERS[name]()


def infer_model_name(weights: str | Path | None) -> str:
    """The backbone named in the weights' file name: the longest name of
    ``MODEL_NAMES`` in its stem (the JAX ``infer_model_name``)."""
    if weights is None:
        return "osnet_x0_25"
    stem = Path(weights).stem.lower()
    for name in sorted(MODEL_NAMES, key=len, reverse=True):
        if name in stem:
            return name
    raise ValueError(f"cannot infer ReID model from weights name {weights!r}")


class ReID:
    """Appearance model with the reference ``get_features`` contract, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, weights: str | Path | None = None, device="cuda", half: bool = False,
                 preprocess_name: str = "resize", model_name: str | None = None,
                 crop_hw: tuple[int, int] = (256, 128)):
        self.device = resolve_device(device)
        self.model_name = model_name or infer_model_name(weights)
        if self.model_name not in MODEL_NAMES:
            raise KeyError(f"unknown ReID model {self.model_name!r}")
        if weights is not None and str(weights).endswith(".msgpack"):
            raise NotImplementedError(
                "flax .msgpack checkpoints need flax's serialization: ROADMAP Queue A item 22")
        # a seeded initialization that leaves the global generator alone, so
        # that a model built without weights is the same on every device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model(self.model_name, crop_hw)
        if weights is not None and Path(str(weights)).exists():
            convert_mod.load_weights(model, convert_mod.convert_checkpoint(str(weights),
                                                                           self.model_name))
        self.crop_hw = tuple(crop_hw)
        self.half = half
        self.preprocess_name = preprocess_name
        self.feature_dim = model.feature_dim
        self.dtype = torch.bfloat16 if half else torch.float32
        self.model = model.eval().to(device=self.device, dtype=self.dtype)

    @torch.no_grad()
    def _embed(self, crops: torch.Tensor) -> torch.Tensor:
        feats = self.model(crops).to(torch.float32)
        norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return feats / torch.clamp_min(norm, 1e-12)

    def _boxes(self, boxes) -> tuple[torch.Tensor, bool]:
        """(boxes on the device, is_obb): five or more columns are rotated
        boxes (cx, cy, w, h, angle), as in the JAX ``get_features``."""
        boxes = torch.as_tensor(boxes, dtype=torch.float32)
        is_obb = boxes.dim() == 2 and boxes.shape[1] >= 5
        cols = 5 if is_obb else 4
        boxes = boxes.reshape(-1, cols) if boxes.dim() != 2 else boxes[:, :cols]
        return boxes.to(self.device).contiguous(), is_obb

    def features(self, boxes, img) -> torch.Tensor:
        """(N, 4) xyxy or (N, 5) xywha boxes and a (H, W, 3) uint8 BGR frame
        (a host array or a tensor) -> (N, F) float32 embeddings on the
        model's device.  Rotated boxes give rotation-rectified crops."""
        boxes, is_obb = self._boxes(boxes)
        n = len(boxes)
        if n == 0:
            return torch.zeros((0, self.feature_dim), dtype=torch.float32, device=self.device)
        frame = as_frame(img, self.device)
        return torch.cat([
            self._embed(extract_crops(frame, boxes[i:i + CHUNK], self.crop_hw, is_obb,
                                      self.dtype))
            for i in range(0, n, CHUNK)])

    def get_features(self, xyxys, img) -> np.ndarray:
        """``features`` as a float32 numpy array."""
        return self.features(xyxys, img).cpu().numpy()

    def get_features_multi(self, boxes_per_frame, imgs) -> list[np.ndarray]:
        """Embeddings of the boxes of several frames, the crops of every
        frame through one backbone batch (in chunks of 256): a list of (Ni,
        F) float32 arrays.  Every non-empty frame's boxes must be of one
        kind, axis-aligned or rotated; a mix raises (the JAX package reads
        the axis-aligned frames of a mix as rotated boxes)."""
        if len(boxes_per_frame) != len(imgs):
            raise ValueError(f"get_features_multi: {len(boxes_per_frame)} box arrays for "
                             f"{len(imgs)} frames")
        boxes = [self._boxes(b) for b in boxes_per_frame]
        kinds = {is_obb for b, is_obb in boxes if len(b)}
        if len(kinds) > 1:
            raise ValueError("get_features_multi: the frames mix axis-aligned (4-column) and "
                             "rotated (5-column) boxes")
        is_obb = kinds.pop() if kinds else False
        crops = [extract_crops(as_frame(img, self.device), b, self.crop_hw, is_obb, self.dtype)
                 for (b, _), img in zip(boxes, imgs) if len(b)]
        if not crops:
            return [np.zeros((0, self.feature_dim), np.float32) for _ in boxes]
        flat = torch.cat(crops)
        feats = torch.cat([self._embed(flat[i:i + CHUNK])
                           for i in range(0, len(flat), CHUNK)]).cpu().numpy()
        out, start = [], 0
        for b, _ in boxes:
            out.append(feats[start:start + len(b)])
            start += len(b)
        return out

    def __call__(self, xyxys, img):
        return self.get_features(xyxys, img)

"""The vendored minimal YOLO predictor (``yololite*``) in PyTorch.

Counterpart of ``boxmot_tpu/detectors/yolo_lite.py`` (``LiteYOLO``,
``LiteResults`` and the ``_Boxes`` / ``_Masks`` / ``_Obb`` / ``_Keypoints``
surfaces of the ultralytics predictor).  It is not a weight-compatible
ultralytics port: it exists so that the ultralytics adapter's four result
families (detect boxes, segment masks, OBB, pose keypoints) run through a
real forward pass offline.  The net, at its full size (``IMGSZ`` 256,
stride 16, 8 mask prototypes, 17 keypoints), runs on ``device`` (the card
unless the caller asks for the CPU), and so does the decode: the head's
grid decode, the class offset, the ``classes`` mask and greedy NMS at
``max_out`` 64 (``ops/nms.py::nms``, kernel K6 on the card: one launch a
call); then the masks' bilinear upsample and the keypoints.  The host half
of ``predict`` (cv2 letterbox, rescale, the drop of boxes of 1 px or less,
the masks' un-letterbox and ``cv2.resize``) is the JAX package's, line for
line.

Matching Flax: its convolutions pad ``"SAME"``, which for a stride-2 3 x 3
convolution on an even input is 0 before and 1 after (``F.pad`` and no
padding here; stride-1 ones pad 1 on both sides), and its ``LayerNorm``
normalizes over the channels alone with epsilon 1e-6.

Weights: a ``yololite*`` stem seeds an explicit ``torch.Generator`` from the
stem's first four bytes (the integer the JAX package seeds Flax with), so a
stem gives the same weights on the CPU and on the card, though not the JAX
package's (``models/convert.py::yololite_state_dict_from_flax`` carries
those across).  A ``.msgpack`` file needs flax's serialization.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boxmot_tpu_torch.models.layers import LN_EPS
from boxmot_tpu_torch.ops.geometry import exact
from boxmot_tpu_torch.ops.nms import nms
from boxmot_tpu_torch.utils.device import resolve_device

IMGSZ = 256  # square inference size (letterboxed)
STRIDE = 16
N_PROTO = 8
N_KPT = 17  # COCO keypoint schema (what yolov8*-pose emits)
MAX_OUT = 64  # NMS keeps at most this many boxes a frame


def task_of(weights) -> str:
    """The head a ``yololite*`` stem selects: segment, obb, pose or detect."""
    stem = Path(str(weights)).stem.lower()
    for task, tag in (("segment", "seg"), ("obb", "obb"), ("pose", "pose")):
        if f"-{tag}" in stem or f"_{tag}" in stem:
            return task
    return "detect"


def seed_of(weights) -> int:
    """The stem's first four bytes as a little-endian integer."""
    stem = Path(str(weights)).stem.lower()
    return int.from_bytes(stem.encode()[:4].ljust(4, b"\0"), "little")


class ConvLNSiLU(nn.Module):
    """3 x 3 convolution (no bias, Flax's "SAME" padding), LayerNorm over the
    channels, SiLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, 3, stride, 0 if stride == 2 else 1, bias=False)
        self.norm = nn.LayerNorm(cout, eps=LN_EPS)

    def forward(self, x):
        if self.stride == 2:
            x = F.pad(x, (0, 1, 0, 1))
        x = self.norm(self.conv(x).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return F.silu(x)


class LiteNet(nn.Module):
    """Backbone to a stride-16 map and the decoupled heads of ``task``:
    box and class always, angle (obb), prototypes at stride 8 and their
    coefficients (segment), keypoints (pose).  NCHW outputs."""

    def __init__(self, task: str, nc: int):
        super().__init__()
        self.task = task
        chans = (3, 16, 32, 64, 128)
        self.stem = nn.ModuleList(ConvLNSiLU(chans[i], chans[i + 1], stride=2) for i in range(4))
        self.neck = ConvLNSiLU(128, 128)
        self.box_stem, self.box = ConvLNSiLU(128, 64), nn.Conv2d(64, 4, 1)
        self.cls_stem, self.cls = ConvLNSiLU(128, 64), nn.Conv2d(64, nc, 1)
        if task == "obb":
            self.angle_stem, self.angle = ConvLNSiLU(128, 32), nn.Conv2d(32, 1, 1)
        if task == "segment":
            self.proto_stem, self.proto = ConvLNSiLU(64, 32), nn.Conv2d(32, N_PROTO, 1)
            self.coef_stem, self.coef = ConvLNSiLU(128, 32), nn.Conv2d(32, N_PROTO, 1)
        if task == "pose":
            self.kpt_stem, self.kpt = ConvLNSiLU(128, 64), nn.Conv2d(64, N_KPT * 3, 1)

    def forward(self, x):
        feats = []
        for conv in self.stem:
            x = conv(x)
            feats.append(x)
        f = self.neck(x)
        out = {"box": self.box(self.box_stem(f)), "cls": self.cls(self.cls_stem(f))}
        if self.task == "obb":
            out["angle"] = self.angle(self.angle_stem(f))
        if self.task == "segment":
            out["proto"] = self.proto(self.proto_stem(feats[2]))
            out["coef"] = self.coef(self.coef_stem(f))
        if self.task == "pose":
            out["kpt"] = self.kpt(self.kpt_stem(f))
        return out


@torch.no_grad()
def seeded_init(model: nn.Module, seed: int) -> None:
    """Flax's default initialization, drawn from a ``torch.Generator`` seeded
    with ``seed`` on the CPU: LeCun-normal kernels (variance 1 / fan-in,
    truncated at two standard deviations), zero biases, unit norm scales."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("weight") and p.dim() == 4:
            std = math.sqrt(1.0 / (p.shape[1] * p.shape[2] * p.shape[3])) / 0.87962566103423978
            w = torch.randn(p.shape, generator=gen)
            while (bad := w.abs() > 2.0).any():
                w[bad] = torch.randn(int(bad.sum()), generator=gen)
            p.copy_(w * std)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A (1, C, h, w) head -> (h * w, C) rows, anchor y * w + x (Flax's
    ``reshape(-1, C)`` of its (h, w, C) map)."""
    return t[0].permute(1, 2, 0).reshape(t.shape[2] * t.shape[3], t.shape[1])


class _Boxes:
    def __init__(self, xyxy, conf, cls):
        self.xyxy, self.conf, self.cls = xyxy, conf, cls

    def __len__(self):
        return len(self.conf)


class _Masks:
    def __init__(self, data):
        self.data = data

    def __len__(self):
        return len(self.data)


class _Obb:
    def __init__(self, xywhr, conf, cls):
        self.xywhr, self.conf, self.cls = xywhr, conf, cls

    def __len__(self):
        return len(self.conf)


class _Keypoints:
    """ultralytics ``Keypoints`` surface: data (N,K,3), xy (N,K,2),
    conf (N,K)."""

    def __init__(self, data):
        self.data = data
        self.xy = data[..., :2]
        self.conf = data[..., 2]

    def __len__(self):
        return len(self.data)


class LiteResults:
    """One frame's predictions, ultralytics-Results-shaped."""

    def __init__(self, boxes=None, masks=None, obb=None, keypoints=None,
                 orig_shape=None):
        self.boxes = boxes
        self.masks = masks
        self.obb = obb
        self.keypoints = keypoints
        self.orig_shape = orig_shape


class LiteYOLO:
    """Callable predictor with the ultralytics ``YOLO`` usage surface the
    adapter exercises: ``model.predict(img, conf=..., iou=..., classes=...,
    agnostic_nms=...) -> [LiteResults]``, on ``device``."""

    def __init__(self, weights="yololite.pt", nc: int = 3, device="cuda"):
        self.device = resolve_device(device)
        self.task = task_of(weights)
        self.nc = nc
        if Path(str(weights)).suffix == ".msgpack":
            raise NotImplementedError(
                "flax .msgpack checkpoints need flax's serialization: ROADMAP Queue A item 22")
        model = LiteNet(self.task, nc)
        seeded_init(model, seed_of(weights))
        self.model = model.eval().to(self.device)
        g = IMGSZ // STRIDE
        gy, gx = torch.meshgrid(torch.arange(g), torch.arange(g), indexing="ij")
        self.grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).to(torch.float32).to(
            self.device)
        self._255 = torch.full((), 255.0, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def decode(self, img: torch.Tensor, conf: float, class_mask: torch.Tensor, agnostic: bool):
        """A letterboxed (IMGSZ, IMGSZ, 3) uint8 frame on the device -> (net
        outputs, xyxy (A, 4), score (A,), cls_id (A,), the NMS input: boxes
        with the class offset (A, 4) and scores with those below ``conf`` at
        -1.0), A = 256 anchors."""
        x = (img.to(torch.float32) / self._255).permute(2, 0, 1)[None]
        out = self.model(x)
        box = _rows(out["box"])
        logits = _rows(out["cls"])
        cxy = (exact(torch.sigmoid, box[:, :2]) + self.grid) * STRIDE
        wh = exact(torch.exp, torch.clamp(box[:, 2:], -4.0, 4.0)) * STRIDE
        prob = exact(torch.sigmoid, logits)
        cls_id = torch.argmax(prob, dim=-1)
        score = prob.amax(dim=-1) * class_mask[cls_id]
        xyxy = torch.cat([cxy - wh / 2, cxy + wh / 2], -1)
        # class-aware NMS by the coordinate offset unless agnostic
        offset = torch.zeros_like(score) if agnostic else cls_id.to(torch.float32) * (IMGSZ * 2)
        conf_t = torch.full((), conf, dtype=torch.float32, device=score.device)
        masked = torch.where(score >= conf_t, score, torch.full_like(score, -1.0))
        return out, xyxy, score, cls_id, xyxy + offset[:, None], masked

    @torch.no_grad()
    def program(self, img: torch.Tensor, conf: float, iou: float, class_mask: torch.Tensor,
                agnostic: bool) -> dict:
        """``decode``, NMS at ``MAX_OUT`` (K6 on the card) and the kept rows'
        heads, all on the device: {"keep_idx", "xyxy", "conf", "cls", "mask"}
        and "angle" (obb), "masks" ((MAX_OUT, IMGSZ, IMGSZ) probabilities,
        segment) or "kpts" ((MAX_OUT, N_KPT, 3), pose).  A keep index of -1
        reads the last anchor's row, as JAX's gather does; "mask" hides it."""
        out, xyxy, score, cls_id, boxes, masked = self.decode(img, conf, class_mask, agnostic)
        keep_idx, keep_mask = nms(boxes, masked, iou, MAX_OUT)
        n = xyxy.shape[0]
        idx = torch.where(keep_idx < 0, keep_idx + n, keep_idx).long()
        res = {"keep_idx": keep_idx, "xyxy": xyxy[idx], "conf": score[idx],
               "cls": cls_id[idx].to(torch.float32), "mask": keep_mask}
        if self.task == "obb":
            ang = _rows(out["angle"])[:, 0]
            # ultralytics OBB angle convention: radians in [-pi/4, 3pi/4)
            res["angle"] = ((exact(torch.sigmoid, ang) - 0.25) * math.pi)[idx]
        if self.task == "segment":
            coef = _rows(out["coef"])[idx]
            proto = out["proto"][0]  # (P, h, w)
            m = exact(torch.sigmoid, torch.einsum("phw,np->nhw", proto, coef))
            res["masks"] = F.interpolate(m[None], size=(IMGSZ, IMGSZ), mode="bilinear",
                                         align_corners=False, antialias=False)[0]
        if self.task == "pose":
            kpt = _rows(out["kpt"]).reshape(-1, N_KPT, 3)
            # anchor-relative decode (yolov8-pose convention: xy may fall up
            # to one cell outside its anchor)
            kxy = (exact(torch.sigmoid, kpt[..., :2]) * 4.0 - 1.5) * STRIDE
            kxy = kxy + self.grid[:, None, :] * STRIDE
            kconf = exact(torch.sigmoid, kpt[..., 2])
            res["kpts"] = torch.cat([kxy, kconf[..., None]], -1)[idx]
        return res

    def class_mask(self, classes) -> np.ndarray:
        class_mask = np.ones((self.nc,), np.float32)
        if classes is not None:
            class_mask[:] = 0.0
            class_mask[np.asarray(classes, int)] = 1.0
        return class_mask

    @staticmethod
    def letterbox(img: np.ndarray):
        """A BGR uint8 frame -> ((IMGSZ, IMGSZ, 3) uint8, scale): cv2's
        resize to fit, padded with 114 below and to the right."""
        import cv2

        h0, w0 = img.shape[:2]
        r = IMGSZ / max(h0, w0)
        resized = cv2.resize(img, (int(w0 * r), int(h0 * r)))
        padded = np.full((IMGSZ, IMGSZ, 3), 114, np.uint8)
        padded[: resized.shape[0], : resized.shape[1]] = resized
        return padded, r

    def predict(self, source, conf=0.25, iou=0.7, classes=None,
                agnostic_nms=False, verbose=False, **kwargs):
        import cv2

        imgs = source if isinstance(source, (list, tuple)) else [source]
        out = []
        for img in imgs:
            h0, w0 = img.shape[:2]
            padded, r = self.letterbox(img)
            res = self.program(
                torch.from_numpy(padded).to(self.device),
                float(conf),
                float(iou),
                torch.from_numpy(self.class_mask(classes)).to(self.device),
                bool(agnostic_nms),
            )
            res = {k: v.cpu().numpy() for k, v in res.items()}
            keep = res["mask"].copy()
            xyxy_all = res["xyxy"] / r
            xyxy_all[:, 0::2] = xyxy_all[:, 0::2].clip(0, w0)
            xyxy_all[:, 1::2] = xyxy_all[:, 1::2].clip(0, h0)
            # boxes fully outside the frame collapse to zero-area slivers
            # on the border when clipped; drop them (ultralytics' predictor
            # never emits degenerate boxes downstream)
            keep &= (xyxy_all[:, 2] - xyxy_all[:, 0] > 1.0) & (
                xyxy_all[:, 3] - xyxy_all[:, 1] > 1.0
            )
            xyxy = xyxy_all[keep]
            score = res["conf"][keep]
            cls = res["cls"][keep]
            result = LiteResults(orig_shape=(h0, w0))
            if self.task == "obb":
                cx = (xyxy[:, 0] + xyxy[:, 2]) / 2
                cy = (xyxy[:, 1] + xyxy[:, 3]) / 2
                w = xyxy[:, 2] - xyxy[:, 0]
                hh = xyxy[:, 3] - xyxy[:, 1]
                ang = res["angle"][keep]
                xywhr = np.stack([cx, cy, w, hh, ang], -1).astype(np.float32)
                result.obb = _Obb(xywhr, score, cls)
                result.boxes = _Boxes(xyxy, score, cls)
            else:
                result.boxes = _Boxes(xyxy, score, cls)
                if self.task == "pose":
                    k = res["kpts"][keep]
                    k[..., :2] /= r
                    k[..., 0] = k[..., 0].clip(0, w0)
                    k[..., 1] = k[..., 1].clip(0, h0)
                    result.keypoints = _Keypoints(k.astype(np.float32))
                if self.task == "segment":
                    n = int(keep.sum())
                    m = res["masks"][keep]
                    # un-letterbox to the original frame resolution
                    mh, mw = int(IMGSZ * h0 / max(h0, w0)), int(IMGSZ * w0 / max(h0, w0))
                    m = m[:, :mh, :mw]
                    if n:
                        m = np.stack(
                            [cv2.resize(mi, (w0, h0)) for mi in m], 0
                        )
                    else:
                        m = np.zeros((0, h0, w0), np.float32)
                    result.masks = _Masks(m)
            out.append(result)
        return out

    __call__ = predict

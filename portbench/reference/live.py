"""The plain reference of a live cell: each frame letterboxed, standardized,
YOLOX's forward, decode, greedy NMS in sorted order (the twin's loop), the
padded detection rows, crops of the uint8 letterbox (the twin's bilinear
taps), the ReID forward, and the tracker's step at S = 1, as
``boxmot_tpu_torch/engine/fused.py::FusedLiveTracker`` defines a frame; no
kernel of the port runs here.  The letterbox is OpenCV's bilinear resize,
as the port's (``detectors/registry.py::letterbox_u8``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.reference import models, trackers
from portbench.reference.frozen.ops.crops import IMAGENET_MEAN, IMAGENET_STD, extract_crops_plain
from portbench.reference.frozen.ops.nms import nms_plain, yolox_decode


def letterbox(img: np.ndarray, imgsz) -> tuple[np.ndarray, float]:
    """A uint8 BGR frame resized to fit ``imgsz`` (h, w), padded with 114."""
    import cv2

    ih, iw = imgsz
    r = min(ih / img.shape[0], iw / img.shape[1])
    resized = cv2.resize(img, (int(img.shape[1] * r), int(img.shape[0] * r)),
                         interpolation=cv2.INTER_LINEAR)
    padded = np.full((ih, iw, 3), 114, np.uint8)
    padded[: resized.shape[0], : resized.shape[1]] = resized
    return padded, r


def standardize(frame_u8: torch.Tensor) -> torch.Tensor:
    """RGB, / 255 in float32, then (x - mean) / std in float64, rounded once."""
    dev = frame_u8.device
    rgb = frame_u8.flip(-1).to(torch.float32) / torch.full((), 255.0, device=dev)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64).to(dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float64).to(dev)
    return ((rgb.double() - mean) / std).to(torch.float32)


def make_weights(cfg: dict, frames: list, players: int, seed: int,
                 device) -> tuple[dict, dict]:
    """(detector state dict, ReID state dict) on the host: seeded on the card
    (``models.seed_weights``); the detector's batch norms calibrated on
    letterboxes of four of ``frames`` and its objectness shifted so that
    they keep ``players`` detections a frame (the players the traffic
    draws) scoring at least the configuration's ``player_score``
    (``shift_objectness``); the ReID model's batch norms, its head's too,
    set from the crops of the detector's own detections on those frames, as
    the tracker will see them."""
    det, rid = cfg["detector"], cfg["reid"]
    gen = models.generator(seed, device)
    yolox = models.yolox(det["name"], det["num_classes"], device)
    models.seed_weights(yolox, gen)
    picks = [frames[i] for i in np.linspace(0, len(frames) - 1, 4).astype(int)]
    boxed = [torch.from_numpy(letterbox(f, det["imgsz"])[0]).to(device) for f in picks]
    x = torch.stack([standardize(b) for b in boxed]).permute(0, 3, 1, 2).contiguous()
    models.calibrate_batch_norms(yolox, x)
    shift_objectness(yolox, x, cfg, players)
    osnet = models.osnet(rid["name"], device)
    models.seed_weights(osnet, gen)
    crops = []
    with torch.no_grad():
        for b, raw in zip(boxed, yolox(x)):
            boxes, obj, cls = yolox_decode(raw, img_hw=tuple(det["imgsz"]))
            score = obj * cls.max(dim=-1).values
            masked = torch.where(score >= float(det["conf"]), score, torch.full_like(score, -1.0))
            keep_idx, keep_mask = nms_plain(boxes, masked, float(det["iou"]), int(cfg["max_dets"]))
            kept = boxes[keep_idx[keep_mask].long()]
            crops.append(extract_crops_plain(b, kept, tuple(rid["crop_hw"])))
    models.calibrate_train_statistics(osnet, torch.cat(crops))
    out = ({k: v.cpu() for k, v in yolox.state_dict().items()},
           {k: v.cpu() for k, v in osnet.state_dict().items()})
    del yolox, osnet
    return out


def shift_objectness(yolox, x: torch.Tensor, cfg: dict, players: int) -> float:
    """Add one bias to every objectness prediction of ``yolox`` so that the
    letterboxed images ``x`` keep ``players`` detections an image, after the
    confidence threshold and NMS, scoring at least the detector's
    ``player_score``; returns the bias.  A seeded net has no players to
    find; this gives it the detections a trained one gives a broadcast
    frame, so that the tracker's load is the source's and not the seed's."""
    det = cfg["detector"]
    with torch.no_grad():
        decoded = []
        for raw in yolox.eval()(x).to(torch.float32):
            boxes, _, cls = yolox_decode(raw, img_hw=tuple(det["imgsz"]))
            decoded.append((boxes, raw[:, 4], cls.max(dim=-1).values))

        def kept(b: float) -> float:
            n = 0
            for boxes, obj, cls in decoded:
                score = torch.sigmoid(obj + b) * cls
                masked = torch.where(score >= det["conf"], score, torch.full_like(score, -1.0))
                idx, mask = nms_plain(boxes, masked, float(det["iou"]), int(cfg["max_dets"]))
                n += int((masked[idx[mask].long()] >= det["player_score"]).sum())
            return n / len(decoded)

        lo, hi = -30.0, 30.0
        for _ in range(16):
            mid = (lo + hi) / 2
            lo, hi = (lo, mid) if kept(mid) >= players else (mid, hi)
        for conv in yolox.head.obj_preds:
            conv.bias += hi
    return hi


class LiveReference:
    """The reference's models on ``device`` from the benchmark's state dicts."""

    def __init__(self, cfg: dict, det_sd: dict, reid_sd: dict, device):
        self.cfg, self.device = cfg, device
        det = cfg["detector"]
        self.yolox = models.yolox(det["name"], det["num_classes"], device)
        self.yolox.load_state_dict(det_sd)
        self.osnet = models.osnet(cfg["reid"]["name"], device)
        self.osnet.load_state_dict(reid_sd)
        D = int(cfg["max_dets"])
        self.unit = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32).to(device)
        self.det_ind = torch.arange(D, dtype=torch.float32, device=device)[:, None]

    @torch.no_grad()
    def frame_inputs(self, frame_bgr: np.ndarray):
        """(dets (D, 7), det_valid (D,), embs (D, F)) on the device, and the
        work of the frame's NMS and crops ({"k6": (N, examined, IoUs),
        "k5": ((h, w), boxes)})."""
        det = self.cfg["detector"]
        padded, r = letterbox(frame_bgr, det["imgsz"])
        u8 = torch.from_numpy(padded).to(self.device)
        x = standardize(u8).permute(2, 0, 1)[None]
        raw = self.yolox(x)[0].to(torch.float32)
        boxes, obj, cls = yolox_decode(raw, img_hw=tuple(det["imgsz"]))
        cls_conf = cls.max(dim=-1).values
        cls_id = torch.argmax(cls, dim=-1).to(torch.float32)
        score = obj * cls_conf
        conf_t = torch.full((), float(det["conf"]), dtype=torch.float32, device=self.device)
        masked = torch.where(score >= conf_t, score, torch.full_like(score, -1.0))
        D = int(self.cfg["max_dets"])
        keep_idx, keep_mask = nms_plain(boxes, masked, float(det["iou"]), D)
        idx = torch.clamp(keep_idx, 0, boxes.shape[0] - 1).long()
        boxes_lb = boxes[idx]
        scale = torch.full((1,), r, dtype=torch.float32, device=self.device)
        keep = keep_mask[:, None]
        dets = torch.cat([torch.where(keep, boxes_lb / scale, self.unit),
                          torch.where(keep_mask, score[idx], -1.0)[:, None],
                          cls_id[idx][:, None], self.det_ind], dim=1)
        crop_box = torch.where(keep, boxes_lb, self.unit)
        crops = extract_crops_plain(u8, crop_box, tuple(self.cfg["reid"]["crop_hw"]))
        embs = torch.where(keep, models.embed(self.osnet, crops), 0.0)
        examined, ious = work.k6_work(masked.cpu().numpy(), keep_idx.cpu().numpy(), D)
        return dets, keep_mask, embs, {"k6": (boxes.shape[0], examined, ious),
                                       "k5": (tuple(padded.shape[:2]), crop_box.cpu().numpy())}


def track(cfg: dict, inputs, device) -> list[np.ndarray]:
    """The emitted (N, 8) rows of each frame of ``inputs`` [(dets, valid,
    embs)], the tracker's step at S = 1 with the identity warp."""
    config, init_state, step = trackers.resolve(cfg["tracker"]["name"])
    tcfg = config(**cfg["tracker"]["params"])
    state = init_state(tcfg, 1, device)
    warp = torch.eye(2, 3, dtype=torch.float32, device=device)[None]
    rows = []
    with torch.no_grad():
        for dets, valid, embs in inputs:
            state, out, mask = step(tcfg, state, dets[None], valid[None], embs[None], warp)
            rows.append(out[0][mask[0]].cpu().numpy())
    return rows

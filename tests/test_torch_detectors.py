"""The port's detector API (``detectors/``, ``engine/inference.py``) against
the JAX package's ``YoloXDetector``, on the CPU.

One seeded yolox_nano (``tests/test_torch_yolox.py::flax_yolox_variables``)
is written as a yolox torch checkpoint by the JAX package's
``export_yolox``; both packages load that file.  The reference is the JAX
``YoloXDetector(...)(frame)``: its staged callers (``Detector.predict_frame``,
``DetectorReIDPipeline``) hand its ``process`` the bare array and fail (the
port's stages compose; ROADMAP, reference-side behaviours).  Frames are
seeded textured 300 x 400 frames, letterboxed to (256, 320) (scale 0.8).

Before comparing, each test asserts that the detections are decided with
room to spare: the smallest gap between a kept score and the next alive one,
between a score and ``conf``, and between an evaluated IoU and ``iou``,
measured on JAX's outputs, exceed the largest difference between the two
forwards' scores (of the candidates) and IoUs; a flip would then be a near
tie, reported as such.  With random weights near ties are common (scores
bunch within 1e-5 of each other at the top, and the forwards differ by up to
7e-6), so the test's frames are seeds whose decisions are clear
(``FRAME_SEEDS``).  Kept indices and classes must be equal; boxes within 2e-2 px plus
rtol 1e-4 and scores within 5e-5 (``tests/test_torch_yolox.py``'s
tolerances, the raw head within 1e-4).
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from boxmot_tpu.detectors.registry import YoloXDetector as JaxYoloX
from boxmot_tpu.models.yolox import export_yolox
from boxmot_tpu_torch.detectors import Detections, create_detector, get_detector_class
from boxmot_tpu_torch.detectors.detector import Detector
from boxmot_tpu_torch.detectors.registry import PublicDetections, YoloXDetector
from boxmot_tpu_torch.engine.inference import DetectorReIDPipeline
from boxmot_tpu_torch.reid import ReID
from boxmot_tpu_torch.utils.autobatch import AutoBatcher, is_oom_error
from chip_smoke import LIVE_SEQ, crop_frame
from tests.test_torch_yolox import flax_yolox_variables

IMGSZ = (256, 320)
CONF, IOU = 0.3, 0.5
# textured frames whose decisions are clear of the forward's error; of seeds
# 30-41, 30, 35, 37 and 38 hold a near tie (a kept score within twice that
# error of the next alive one), and on seed 35 the kept indices do differ
FRAME_SEEDS = (32, 34, 36)
BOX_ATOL, BOX_RTOL, SCORE_ATOL = 2e-2, 1e-4, 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A yolox torch checkpoint of a seeded yolox_nano, from JAX's exporter."""
    variables = flax_yolox_variables("yolox_nano", seed=3)
    sd = {f"model.{k}": torch.from_numpy(np.array(v))
          for k, v in export_yolox(variables, "yolox_nano").items()}
    path = tmp_path_factory.mktemp("yolox") / "yolox_nano.pth"
    torch.save({"model": sd}, path)
    return str(path)


@pytest.fixture(scope="module")
def detectors(weights):
    kw = dict(imgsz=IMGSZ, conf=CONF, iou=IOU)
    return JaxYoloX(weights, **kw), YoloXDetector(weights, device="cpu", **kw)


@pytest.fixture(scope="module")
def frames():
    return [crop_frame(seed, (300, 400)) for seed in FRAME_SEEDS]


def _iou(a, b):
    """iou_batch of one box against many, float64."""
    xx1, yy1 = np.maximum(a[0], b[:, 0]), np.maximum(a[1], b[:, 1])
    xx2, yy2 = np.minimum(a[2], b[:, 2]), np.minimum(a[3], b[:, 3])
    wh = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - wh
    return wh / np.maximum(union, 1e-12)


def decision_margins(boxes, score, other_boxes, conf, iou, max_out):
    """Greedy NMS over ``boxes``/``score`` (float64), returning (smallest gap
    between a kept score and the best other alive score, smallest |score -
    conf|, smallest |IoU - iou| over the evaluated pairs, largest |IoU -
    IoU'| of those pairs against ``other_boxes``)."""
    boxes, other_boxes = boxes.astype(np.float64), other_boxes.astype(np.float64)
    alive = score >= conf
    gap, iou_gap, iou_err, n = np.inf, np.inf, 0.0, 0
    while alive.any() and n < max_out:
        s = np.where(alive, score, -np.inf)
        best = int(np.argmax(s))
        rest = np.delete(s, best)
        if np.isfinite(rest.max()):
            gap = min(gap, s[best] - rest.max())
        alive[best] = False
        n += 1
        idx = np.flatnonzero(alive)
        if len(idx):
            v = _iou(boxes[best], boxes[idx])
            iou_gap = min(iou_gap, float(np.abs(v - iou).min()))
            iou_err = max(iou_err, float(np.abs(v - _iou(other_boxes[best], other_boxes[idx])).max()))
            alive[idx[v > iou]] = False
    return gap, float(np.abs(score - conf).min()), iou_gap, iou_err


def _same(a: Detections, b: Detections, what: str):
    assert len(a) == len(b) > 0, what
    np.testing.assert_array_equal(a.cls, b.cls, err_msg=what)
    np.testing.assert_allclose(a.conf, b.conf, atol=SCORE_ATOL, rtol=0, err_msg=what)
    np.testing.assert_allclose(a.xyxy, b.xyxy, atol=BOX_ATOL, rtol=BOX_RTOL, err_msg=what)


def test_detections_equal_jax(detectors, frames):
    """The port's ``YoloXDetector(frame)``, ``Detector.predict_frame`` and
    ``DetectorReIDPipeline`` return the JAX detector's detections, with the
    same kept indices, on decisions that the forward's error cannot flip."""
    jdet, tdet = detectors
    pipe = DetectorReIDPipeline(tdet, skip_frame_errors=False)
    runner = Detector(tdet)
    suppressed = 0
    for f, frame in enumerate(frames):
        jboxes, jscore, _, jkeep, jmask, r = jdet.process(jdet.preprocess(frame))
        batch, meta = tdet.preprocess(frame)
        assert meta == r
        tboxes, tscore, _, tkeep, tmask = (t.numpy() for t in tdet.process(batch))
        cand = np.maximum(jscore, tscore) >= CONF - 1e-3  # the scores the decisions read
        score_err = float(np.abs(tscore - jscore)[cand].max())
        gap, conf_gap, iou_gap, iou_err = decision_margins(jboxes, jscore.astype(np.float64),
                                                           tboxes, CONF, IOU, tdet.MAX_DETS)
        assert gap > 2 * score_err and conf_gap > score_err and iou_gap > iou_err, (
            f"frame {f}: near tie (score gap {gap:.3g}, conf gap {conf_gap:.3g}, IoU gap "
            f"{iou_gap:.3g}) within the forward's error (scores {score_err:.3g}, IoUs "
            f"{iou_err:.3g})")
        np.testing.assert_array_equal(tkeep, jkeep)
        np.testing.assert_array_equal(tmask, jmask)
        suppressed += int((jscore >= CONF).sum() - jmask.sum())
        want = jdet(frame)
        _same(tdet(frame), want, f"frame {f}: YoloXDetector")
        _same(runner.predict_frame(frame), want, f"frame {f}: Detector.predict_frame")
        dets, embs, result = pipe(frame)
        assert embs is None and dets.shape == (len(want), 6) and dets.dtype == np.float32
        _same(result, want, f"frame {f}: DetectorReIDPipeline")
    assert suppressed > 0  # the IoU test decided something
    assert pipe.failed_frames == 0 and pipe.frames == len(frames)
    assert runner.timing.counts["det_process"] == len(frames)


def test_pipeline_embeddings_and_batches(detectors, frames):
    """With a ReID model the pipeline's embeddings are the facade's on the
    frame's boxes, also when the AutoBatcher splits them."""
    _, tdet = detectors
    reid = ReID("osnet_x0_25", device="cpu", crop_hw=(64, 32))
    for batch_size in (0, 4):
        pipe = DetectorReIDPipeline(tdet, reid, batch_size=batch_size, skip_frame_errors=False)
        dets, embs, _ = pipe(frames[0])
        np.testing.assert_allclose(embs, reid.get_features(dets[:, :4], frames[0]), atol=1e-5)
        assert embs.shape == (len(dets), 512) and pipe.timing.counts["reid"] == 1


def test_half_tier_keeps_decode_and_nms_in_float32(weights, frames):
    det = YoloXDetector(weights, device="cpu", half=True, imgsz=IMGSZ, conf=CONF, iou=IOU)
    assert next(det.model.parameters()).dtype == torch.bfloat16
    boxes, score, _, keep, mask = det.process(det.preprocess(frames[0])[0])
    assert boxes.dtype == score.dtype == torch.float32 and keep.dtype == torch.int32
    out = det(frames[0])
    assert len(out) > 0 and out.xyxy.dtype == np.float32 and np.isfinite(out.xyxy).all()


def test_detector_streams_a_sequence_with_callbacks(detectors):
    """``Detector`` over a MOT sequence directory: one Detections a frame,
    callbacks fired, stages timed."""
    _, tdet = detectors
    runner = Detector(tdet)
    seen = []
    runner.add_callback("on_predict_frame_end", lambda d, ident, dets: seen.append(len(dets)))
    out = runner(LIVE_SEQ)
    n = len(list((LIVE_SEQ / "img1").glob("*.jpg")))
    assert len(out) == len(seen) == n and all(isinstance(d, Detections) for d in out)
    assert runner.timing.counts["det_preprocess"] == n
    with pytest.raises(ValueError, match="unknown event"):
        runner.add_callback("on_nothing", print)


def test_registry_routes_and_refuses(monkeypatch):
    assert get_detector_class("weights/yolox_x_MOT17_ablation.pt") is YoloXDetector
    det = create_detector("yolox_nano.pt", device="cpu", imgsz=(64, 96))
    assert isinstance(det, YoloXDetector) and det.imgsz == (64, 96)
    # the vendored yololite predictor builds; other ultralytics stems need the
    # ultralytics package and RT-DETR transformers (hidden here, so that
    # nothing is fetched from its hub), as in the JAX registry
    lite = create_detector("yololite-seg.pt", device="cpu")
    assert type(lite).__name__ == "UltralyticsDetector" and lite.model.task == "segment"
    monkeypatch.setitem(sys.modules, "ultralytics", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    for weights, match in (("yolov8n.pt", "ultralytics is not installed"),
                           ("rtdetr-l", "transformers is required for RT-DETR"),
                           ("rt-detr-x", "transformers is required for RT-DETR")):
        with pytest.raises(ImportError, match=match):
            create_detector(weights, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            YoloXDetector(None, imgsz=(64, 96))  # the card unless the caller asks for the CPU


def test_public_detections_replay():
    dets = [np.array([[1, 2, 30, 40, 0.9, 0]], np.float32), np.zeros((0, 6), np.float32)]
    pub = PublicDetections(dets)
    a, b, c = (pub(np.zeros((4, 4, 3), np.uint8)) for _ in range(3))
    assert len(a) == 1 and a.xyxy.tolist() == [[1, 2, 30, 40]] and len(b) == len(c) == 0
    np.testing.assert_array_equal(a.as_dets(), dets[0])


def test_autobatcher_backs_off_on_a_cuda_oom():
    assert is_oom_error(torch.OutOfMemoryError("CUDA out of memory"))
    assert is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    assert not is_oom_error(ValueError("shape"))
    calls = []

    def fn(chunk):
        calls.append(len(chunk))
        if len(chunk) > 3:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return np.asarray(chunk) * 2

    ab = AutoBatcher(batch_size=8)
    np.testing.assert_array_equal(ab.map(fn, np.arange(10)), np.arange(10) * 2)
    assert ab.batch_size == 2 and calls[:2] == [8, 4]

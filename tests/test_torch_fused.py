"""The port's fused live step (``engine/fused.py::FusedLiveTracker``)
against its staged composition and against the JAX package's
``FusedLiveTracker``, on the CPU.

Weights: the seeded yolox_nano of ``tests/test_torch_detectors.py`` and the
seeded osnet_x0_25 of ``tests/test_torch_reid.py`` (crops of 64 x 32), each
written as a torch checkpoint that both packages load.  Frames: four 300 x
400 windows of a seeded textured image, panning 3 px down and 5 px right a
frame, letterboxed to (256, 320).  The trackers' thresholds are lowered to
the seeded detector's scores (0.3-0.6) so that tracks are born.

Tolerances: the port's fused detections equal its staged detector's bit for
bit (the device standardization gives the host one's bits).  Against JAX:
ids and ``det_ind`` exact, boxes within 1e-2 px, confidences within 5e-5
(the JAX program standardizes in float32, the port in float64 as the staged
path does, so the forwards differ by the input's last bit and the float32
convolutions' order: see ``tests/test_torch_detectors.py``).  JAX crops the
undone standardization and K5 crops the uint8 letterbox, so the embeddings
differ by about 1e-6 besides the backbones' 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from boxmot_tpu.detectors.registry import YoloXDetector as JaxYoloX
from boxmot_tpu.engine.fused import FusedLiveTracker as JaxFused
from boxmot_tpu.models.convert import export_osnet_state_dict
from boxmot_tpu.reid.core import ReID as JaxReID
from boxmot_tpu_torch import create_tracker
from boxmot_tpu_torch.detectors.registry import YoloXDetector
from boxmot_tpu_torch.engine.fused import FusedLiveTracker
from boxmot_tpu_torch.ops.crops import extract_crops
from boxmot_tpu_torch.reid import ReID
from chip_smoke import crop_frame
from tests.test_torch_detectors import CONF, IMGSZ, IOU, decision_margins
from tests.test_torch_detectors import weights  # noqa: F401 (a fixture)
from tests.test_torch_reid import flax_variables

CROP_HW = (64, 32)
MAX_DETS = 32
PARAMS = {"bytetrack": {"track_thresh": 0.35, "det_thresh": 0.35},
          "occluboost": {"det_thresh": 0.35, "new_track_thresh": 0.35, "use_cmc": False}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reid_weights(tmp_path_factory):
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_osnet_state_dict(flax_variables("osnet_x0_25", 7)).items()}
    path = tmp_path_factory.mktemp("reid") / "osnet_x0_25_seeded.pth"
    torch.save({"state_dict": sd}, path)
    return path


@pytest.fixture(scope="module")
def frames():
    big = crop_frame(32, (330, 460))
    return [big[3 * i:3 * i + 300, 5 * i:5 * i + 400].copy() for i in range(4)]


@pytest.fixture(scope="module")
def detector(weights):  # noqa: F811
    return YoloXDetector(weights, device="cpu", imgsz=IMGSZ, conf=CONF, iou=IOU)


def _fused(detector, reid, tracker):
    return FusedLiveTracker(detector, reid, tracker, PARAMS[tracker], max_dets=MAX_DETS)


def _rows(fused, frames):
    """Each frame's emitted rows.  Where PyTorch has CUDA the frame runs under
    sync debug mode "error", as ``chip_smoke.py`` runs it on the card (there
    any host sync in the frame raises); a CPU-only build cannot set the mode
    (setting it initializes CUDA), and the path is the same."""
    out = []
    guard = torch.cuda.is_available()
    for frame in frames:
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            rows, mask = fused.update_async(frame)
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(0)
        assert rows.shape == (fused.cfg.capacity, 8) and mask.dtype == torch.bool
        out.append(rows.numpy()[mask.numpy()])
    return out


def test_fused_detections_equal_the_staged_detector(detector, frames):
    """The fused frame's detection rows are the staged detector's first
    ``max_dets`` detections, bit for bit, with det_ind 0..D-1 and padding
    rows of unit boxes and conf -1."""
    fused = _fused(detector, None, "bytetrack")
    for frame in frames:
        padded, r = detector.preprocess_u8(frame)
        dets, valid, embs = fused.frame_inputs(torch.from_numpy(padded), r)
        staged = detector(frame)
        n = min(len(staged), MAX_DETS)
        assert embs is None and int(valid.sum()) == n > 0
        want = np.concatenate([staged.xyxy, staged.conf[:, None], staged.cls[:, None]], 1)[:n]
        np.testing.assert_array_equal(dets[:n, :6].numpy(), want)
        np.testing.assert_array_equal(dets[:, 6].numpy(), np.arange(MAX_DETS))
        np.testing.assert_array_equal(dets[n:, :5].numpy(),
                                      np.tile([0, 0, 1, 1, -1], (MAX_DETS - n, 1)))


def test_fused_tracks_equal_the_staged_composition(detector, reid_weights, frames):
    """The port's counterpart of tests/test_fused_live.py:58: the staged
    detector, K5 crops of the letterbox, the ReID model and the live
    tracker's ``update`` give the fused rows."""
    reid = ReID(weights=reid_weights, device="cpu", crop_hw=CROP_HW)
    fused = _fused(detector, reid, "occluboost")

    class _NoCall:
        def features(self, *a, **k):  # pragma: no cover
            raise AssertionError("the staged leg passes embs itself")

    staged = create_tracker("occluboost", device="cpu", reid_model=_NoCall(), with_reid=True,
                            feat_dim=reid.feature_dim, **PARAMS["occluboost"])
    n_rows = 0
    for f, (frame, out_f) in enumerate(zip(frames, _rows(fused, frames))):
        dets = detector(frame)
        n = min(len(dets), MAX_DETS)
        padded, r = detector.preprocess_u8(frame)
        boxes = torch.from_numpy(dets.xyxy[:n] * np.float32(r))
        crops = extract_crops(torch.from_numpy(padded), boxes, CROP_HW)
        embs = reid._embed(crops).numpy()
        d6 = dets.as_dets()[:n]
        out_s = np.asarray(staged.update(d6, frame, embs=embs))
        assert out_f.shape == out_s.shape, f"frame {f}"
        np.testing.assert_array_equal(out_f[:, 4:], out_s[:, 4:], err_msg=f"frame {f}")
        np.testing.assert_allclose(out_f[:, :4], out_s[:, :4], atol=1e-3, err_msg=f"frame {f}")
        n_rows += len(out_f)
    assert n_rows > 0


@pytest.mark.parametrize("tracker", ["bytetrack", "occluboost"])
def test_fused_rows_equal_jax(tracker, weights, reid_weights, detector, frames):  # noqa: F811
    """The port's fused rows against JAX ``FusedLiveTracker``'s on the same
    weights and frames: ids and det_ind exact."""
    jdet = JaxYoloX(weights, imgsz=IMGSZ, conf=CONF, iou=IOU)
    for f, frame in enumerate(frames):  # the detections are decided clear of the error
        jb, js, _, _, _, _ = jdet.process(jdet.preprocess(frame))
        tb, ts, *_ = (t.numpy() for t in detector.process(detector.preprocess(frame)[0]))
        err = float(np.abs(ts - js)[np.maximum(ts, js) >= CONF - 1e-3].max())
        gap, conf_gap, iou_gap, iou_err = decision_margins(jb, js.astype(np.float64), tb, CONF,
                                                           IOU, MAX_DETS)
        assert gap > 2 * err and conf_gap > err and iou_gap > iou_err, f"frame {f}: near tie"
    with_reid = tracker == "occluboost"
    jreid = JaxReID(weights=reid_weights, crop_hw=CROP_HW) if with_reid else None
    treid = ReID(weights=reid_weights, device="cpu", crop_hw=CROP_HW) if with_reid else None
    jfused = JaxFused(jdet, jreid, tracker, PARAMS[tracker], max_dets=MAX_DETS)
    tfused = _fused(detector, treid, tracker)
    n_rows = 0
    for f, (frame, got) in enumerate(zip(frames, _rows(tfused, frames))):
        want = np.asarray(jfused.update(frame).data)
        assert got.shape == want.shape, f"frame {f}"
        np.testing.assert_array_equal(got[:, [4, 6, 7]], want[:, [4, 6, 7]], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, 5], want[:, 5], atol=5e-5, err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-2, err_msg=f"frame {f}")
        n_rows += len(got)
    assert n_rows > 0


def test_update_reset_and_devices(detector, frames):
    fused = _fused(detector, None, "bytetrack")
    a = np.asarray(fused.update(frames[0]).data)
    b = np.asarray(fused.update(frames[1]).data)
    fused.reset()
    np.testing.assert_array_equal(np.asarray(fused.update(frames[0]).data), a)
    assert fused.frame_count == 1 and b.shape[1] == 8

    class _Elsewhere:
        device = torch.device("cuda", 0)
        feature_dim = 512

    with pytest.raises(ValueError, match="share one device"):
        FusedLiveTracker(detector, _Elsewhere(), "occluboost")

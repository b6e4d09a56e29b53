"""The port's ``yololite*`` predictor and the ultralytics / RT-DETR adapters
(``detectors/yolo_lite.py``, ``detectors/registry.py``) against the JAX
package's, on the CPU.

The JAX ``LiteYOLO`` builds its Flax weights from the stem's seed; the
port's ``LiteNet`` gets them through
``models/convert.py::yololite_state_dict_from_flax``, and both predict on
the same seeded non-square frames (one JAX compile a task).  Tolerances:
the kept sets equal (same count, same order), boxes within 1e-3 px,
confidences within 1e-5, mask probabilities and keypoints within 1e-4 (the
convolutions sum in another order; the port's sigmoid and exp are
correctly rounded, XLA's within an ulp).  The masks' bilinear upsample is
held to ``jax.image.resize`` on its own as well.
"""

from __future__ import annotations

import inspect
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from boxmot_tpu.detectors import registry as jregistry
from boxmot_tpu.detectors.yolo_lite import LiteYOLO as JaxLiteYOLO
from boxmot_tpu_torch.detectors import create_detector, get_detector_class
from boxmot_tpu_torch.detectors import registry as tregistry
from boxmot_tpu_torch.detectors.yolo_lite import IMGSZ, MAX_OUT, LiteYOLO, seed_of, task_of
from boxmot_tpu_torch.models.convert import yololite_state_dict_from_flax

TASKS = {"detect": "yololite.pt", "segment": "yololite-seg.pt", "obb": "yololite-obb.pt",
         "pose": "yololite-pose.pt"}
OPTIONS = ({"conf": 0.05}, {"conf": 0.05, "agnostic_nms": True}, {"conf": 0.05, "classes": [1]},
           {"conf": 0.25, "iou": 0.5})
FRAMES = ((180, 320), (300, 200))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def frame(hw, seed=0):
    """A textured frame: smooth blobs on noise, so the random net's heads vary."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    img = rng.integers(0, 64, (h, w, 3)).astype(np.float32)
    for _ in range(12):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 40)
        img += rng.uniform(60, 190, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / r**2)[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def carried(weights):
    """(JAX LiteYOLO, the port's LiteYOLO on the CPU with the JAX weights)."""
    jax_model = JaxLiteYOLO(weights)
    model = LiteYOLO(weights, device="cpu")
    variables = jax.tree.map(np.asarray, jax_model.variables)
    model.model.load_state_dict(yololite_state_dict_from_flax(variables, model.task))
    return jax_model, model


def assert_results_close(want, got, task):
    assert len(got.boxes) == len(want.boxes)
    np.testing.assert_allclose(got.boxes.xyxy, want.boxes.xyxy, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.boxes.conf, want.boxes.conf, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.boxes.cls, want.boxes.cls)
    assert got.orig_shape == want.orig_shape
    if task == "obb":
        np.testing.assert_allclose(got.obb.xywhr, want.obb.xywhr, rtol=0, atol=1e-3)
    if task == "segment":
        assert got.masks.data.shape == want.masks.data.shape
        np.testing.assert_allclose(got.masks.data, want.masks.data, rtol=0, atol=1e-4)
    if task == "pose":
        np.testing.assert_allclose(got.keypoints.data, want.keypoints.data, rtol=0, atol=1e-4)
    for attr in {"detect": ("masks", "obb", "keypoints"), "segment": ("obb", "keypoints"),
                 "obb": ("masks", "keypoints"), "pose": ("masks", "obb")}[task]:
        assert getattr(got, attr) is None and getattr(want, attr) is None


@pytest.mark.parametrize("task", sorted(TASKS))
def test_lite_yolo_equals_jax(task):
    """Per task, on two non-square frames: class-aware NMS, agnostic NMS, a
    ``classes`` filter and the default conf at another IoU threshold."""
    jax_model, model = carried(TASKS[task])
    assert model.task == jax_model.task == task
    kept = []
    for hw in FRAMES:
        img = frame(hw, seed=hw[0])
        for opts in OPTIONS:
            want, = jax_model.predict(img, **opts)
            got, = model(img, **opts)
            assert_results_close(want, got, task)
            kept.append(len(got.boxes))
            if "classes" in opts:
                assert set(got.boxes.cls.tolist()) <= {1.0}
    assert min(kept) > 0 and max(kept) < MAX_OUT, kept  # boxes kept, and fewer than max_out


def test_mask_upsample_equals_jax_resize():
    """``F.interpolate`` (bilinear, half-pixel centres, no antialias) is
    ``jax.image.resize(..., "bilinear")`` for the 8x upsample, edges
    included."""
    m = np.random.default_rng(5).uniform(0, 1, (MAX_OUT, 32, 32)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (MAX_OUT, IMGSZ, IMGSZ), method="bilinear"))
    got = F.interpolate(torch.from_numpy(m)[None], size=(IMGSZ, IMGSZ), mode="bilinear",
                        align_corners=False, antialias=False)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_adapter_postprocess_equals_jax():
    """``UltralyticsDetector`` on the yololite stems, JAX weights carried:
    detections, the OBB hull and masks binarized at 0.5 as in JAX (a pixel
    whose probability lies within 1e-5 of 0.5 may flip)."""
    img = frame((300, 200), seed=9)
    for task, weights in TASKS.items():
        jdet = jregistry.create_detector(weights, conf=0.05)
        tdet = create_detector(weights, device="cpu", conf=0.05)
        assert type(tdet) is tregistry.UltralyticsDetector and tdet.model.task == task
        tdet.model.model.load_state_dict(yololite_state_dict_from_flax(
            jax.tree.map(np.asarray, jdet.model.variables), task))
        want, got = jdet(img), tdet(img)
        assert len(got) == len(want) > 0 and got.is_obb == want.is_obb == (task == "obb")
        np.testing.assert_allclose(got.as_dets(), want.as_dets(), rtol=0, atol=1e-3)
        if task == "segment":
            probs = tdet.model(img, conf=0.05)[0].masks.data
            close = np.abs(probs - 0.5) <= 1e-5
            assert got.masks.dtype == want.masks.dtype == np.uint8
            np.testing.assert_array_equal(got.masks[~close], want.masks[~close])
        if task == "pose":
            np.testing.assert_allclose(got.keypoints, want.keypoints, rtol=0, atol=1e-4)


def test_seeded_weights_and_refusals(monkeypatch):
    """A stem seeds the port's weights (the same net every time, the JAX
    package's integer), also for a ``.msgpack`` path that does not exist;
    the adapters without their packages raise the JAX package's ImportErrors
    (``transformers`` is hidden here: where it is installed, RT-DETR would
    fetch the named model from its hub); the card is the default."""
    assert seed_of("weights/yololite-seg.pt") == int.from_bytes(b"yolo", "little")
    assert task_of("yololite_obb.pt") == "obb" and task_of("yololite.pt") == "detect"
    a, b = LiteYOLO("yololite-pose.pt", device="cpu"), LiteYOLO("yololite-pose.pt", device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                 b.model.state_dict().values()))
    got, = a(frame((180, 320)), conf=0.05)
    assert len(got.boxes) > 0 and got.keypoints.data.shape == (len(got.boxes), 17, 3)
    # a .msgpack that does not exist gives the stem's seeded weights, as in JAX
    # (tests/test_torch_export.py loads one that JAX wrote)
    c, d = LiteYOLO("yololite.msgpack", device="cpu"), LiteYOLO("yololite.pt", device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(c.model.state_dict().values(),
                                                 d.model.state_dict().values()))
    for weights in ("yolov8n.pt", "yolo11s-seg.pt"):
        assert get_detector_class(weights) is tregistry.UltralyticsDetector
        with pytest.raises(ImportError) as port_err:
            create_detector(weights, device="cpu")
        with pytest.raises(ImportError) as jax_err:
            jregistry.create_detector(weights)
        assert str(port_err.value) == str(jax_err.value)
    monkeypatch.setitem(sys.modules, "transformers", None)  # importing it now raises
    for weights in ("rtdetr-l", "rt-detr-x.pt"):
        assert get_detector_class(weights) is tregistry.RTDetrDetector
        for make in (lambda: create_detector(weights, device="cpu"),
                     lambda: jregistry.create_detector(weights)):
            with pytest.raises(ImportError, match="^transformers is required for RT-DETR$"):
                make()
    for fn in (LiteYOLO, tregistry.UltralyticsDetector.__init__,
               tregistry.RTDetrDetector.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            LiteYOLO("yololite.pt")


def test_rtdetr_adapter_matches_jax_on_a_local_model(tmp_path, monkeypatch):
    """Where ``transformers`` is installed, the RT-DETR adapter runs a tiny
    seeded RT-DETR saved to a local folder (nothing is fetched) on the device
    it was given, and its detections equal the JAX package's adapter's."""
    monkeypatch.setenv("USE_TF", "0")  # the torch side of transformers only
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    tf = pytest.importorskip("transformers")
    backbone = tf.RTDetrResNetConfig(embedding_size=8, hidden_sizes=[16, 32, 64, 128],
                                     depths=[1, 1, 1, 1], out_features=["stage2", "stage3", "stage4"])
    cfg = tf.RTDetrConfig(backbone_config=backbone, encoder_hidden_dim=16,
                          encoder_in_channels=[32, 64, 128], encoder_ffn_dim=32,
                          encoder_attention_heads=2, d_model=16, num_queries=20,
                          decoder_in_channels=[16, 16, 16], decoder_ffn_dim=32, decoder_layers=1,
                          decoder_attention_heads=2, num_denoising=0, num_labels=3)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tf.RTDetrForObjectDetection(cfg).save_pretrained(tmp_path / "rtdetr-tiny")
    tf.RTDetrImageProcessor(size={"height": 64, "width": 64}).save_pretrained(tmp_path / "rtdetr-tiny")
    weights = str(tmp_path / "rtdetr-tiny")
    det = create_detector(weights, device="cpu", conf=0.0)
    assert det.device == torch.device("cpu") and next(det.model.parameters()).device == det.device
    img = frame((90, 120), seed=3)
    got, want = det(img), jregistry.create_detector(weights, conf=0.0)(img)
    assert len(got) == len(want) == 20
    for a, b in ((got.xyxy, want.xyxy), (got.conf, want.conf), (got.cls, want.cls)):
        assert a.dtype == np.float32 and np.array_equal(a, b)

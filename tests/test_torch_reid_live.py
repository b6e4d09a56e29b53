"""The port's live appearance trackers computing their embeddings with a ReID
model from the frame (``reid_model=``, ``create_tracker(..., reid_weights=)``),
against the JAX package's, on the CPU.

A JAX ``ReID`` (osnet_x0_25 read from a torchreid-format checkpoint of
seeded random weights whose batch norms are calibrated on crops of a seeded
frame, ``chip_smoke.reid_checkpoint``, so that the features vary with the
crop as a trained model's do; 64 x 32 crops) and the port's ``ReID``
carried from its variables by ``osnet_state_dict_from_flax`` feed the JAX and the
port's BoT-SORT (axis-aligned and oriented: rotated crops) and DeepOCSORT,
CMC off, over 12 frames of seeded identities (``chip_smoke.
occlusion_frames``, scaled onto a 360 x 640 textured frame, with no
``embs``).  Ids, ``cls`` and ``det_ind`` exact; confidences exact; boxes at
atol 1e-3 px (the features agree within 1e-4, far inside the appearance
gates' margins).  Then each of the six appearance trackers builds through
``create_tracker(..., reid_weights=<checkpoint>, device="cpu")`` with its
YAML defaults and runs 3 frames.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import boxmot_tpu
from boxmot_tpu.reid import core as jcore
from boxmot_tpu_torch import create_tracker
from boxmot_tpu_torch.models.convert import load_weights, osnet_state_dict_from_flax
from boxmot_tpu_torch.reid import ReID
from chip_smoke import occlusion_frames, reid_checkpoint
from tests.test_torch_reid import HW

SCALE = 3.0  # occlusion_frames' 1920 x 1080 scene onto a 640 x 360 frame
N_FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return reid_checkpoint(tmp_path_factory.mktemp("reid"), "osnet_x0_25", seed=1, crop_hw=HW)


@pytest.fixture(scope="module")
def models(checkpoint):
    """(JAX ReID, the port's ReID carried from the JAX variables)."""
    jax_reid = jcore.ReID(weights=checkpoint, crop_hw=HW)
    reid = ReID(model_name="osnet_x0_25", device="cpu", crop_hw=HW)
    load_weights(reid.model, osnet_state_dict_from_flax(
        {k: jax_reid.variables[k] for k in ("params", "batch_stats")}, "osnet_x0_25"))
    return jax_reid, reid


def scene(obb: bool):
    frames, _ = occlusion_frames(N_FRAMES, 6, seed=5, obb=obb, speed=6.0)
    for f in frames:
        f[:, :4] /= SCALE
    texture = np.random.default_rng(3).integers(0, 256, (380, 680, 3), dtype=np.uint8)
    imgs = [np.ascontiguousarray(texture[k % 7:k % 7 + 360, k:k + 640]) for k in range(N_FRAMES)]
    return frames, imgs


LIVE = {"botsort": (dict(use_cmc=False), False), "botsort-obb": (dict(use_cmc=False), True),
        "deepocsort": (dict(cmc_off=True), False)}
CAPACITY = 32  # track slots: the scene has six identities


@pytest.mark.parametrize("case", list(LIVE))
def test_live_tracker_with_reid_model_equals_jax(case, models):
    jax_reid, reid = models
    kw, obb = LIVE[case]
    name = case.removesuffix("-obb")
    jt = boxmot_tpu.create_tracker(name, reid_model=jax_reid, capacity=CAPACITY, **kw)
    tt = create_tracker(name, device="cpu", reid_model=reid, capacity=CAPACITY, **kw)
    assert tt.model is reid and tt.cfg.feat_dim == 512
    frames, imgs = scene(obb)
    rows = 0
    for f, (dets, img) in enumerate(zip(frames, imgs)):
        want = np.asarray(jt.update(dets, img))
        got = np.asarray(tt.update(dets, img))
        assert got.shape == want.shape, f
        ids = [5, 6, 7, 8] if obb else [4, 5, 6, 7]
        np.testing.assert_array_equal(got[:, ids], want[:, ids], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, :ids[0]], want[:, :ids[0]], rtol=0, atol=1e-3)
        rows += len(got)
    assert rows > 20


@pytest.mark.parametrize("name", ["botsort", "deepocsort", "boosttrack", "occluboost",
                                  "strongsort", "hybridsort"])
def test_create_tracker_with_reid_weights(name, checkpoint):
    """The zoo builds the tracker's ReID from a checkpoint on its device, as
    the JAX zoo does; the model then computes the embeddings of every frame
    (one ``features`` call a frame with detections)."""
    trk = create_tracker(name, device="cpu", reid_weights=checkpoint)
    assert isinstance(trk.model, ReID) and trk.model.device == torch.device("cpu")
    assert trk.cfg.feat_dim == trk.model.feature_dim == 512
    calls, features = [], trk.model.features
    trk.model.features = lambda b, img: calls.append(len(b)) or features(b, img)
    img = np.random.default_rng(0).integers(0, 255, (480, 640, 3), dtype=np.uint8)
    dets = np.array([[10, 10, 50, 90, 0.9, 0], [200, 40, 260, 160, 0.8, 2]], np.float32)
    for _ in range(3):
        out = trk.update(dets, img)
    assert out.shape == (2, 8) and np.isfinite(out).all() and calls == [2, 2, 2]
    assert create_tracker("bytetrack", device="cpu", reid_weights=checkpoint).__dict__.get(
        "model") is None  # a motion-only tracker takes no model


def test_a_model_with_only_get_features_feeds_the_shell(models):
    """A ``reid_model`` with only the reference's ``get_features`` (numpy
    out) gives the rows the port's ``ReID`` gives (its features kept on the
    device)."""
    _, reid = models

    class Reference:
        feature_dim = reid.feature_dim

        def get_features(self, boxes, img):
            return reid.get_features(boxes, img)

    kw = dict(device="cpu", use_cmc=False, capacity=CAPACITY)
    a = create_tracker("botsort", reid_model=reid, **kw)
    b = create_tracker("botsort", reid_model=Reference(), **kw)
    frames, imgs = scene(False)
    for dets, img in zip(frames[:6], imgs):
        np.testing.assert_array_equal(np.asarray(b.update(dets, img)),
                                      np.asarray(a.update(dets, img)))

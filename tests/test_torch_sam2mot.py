"""The port's sam2mot (a host tracker in both packages) against the JAX one.

The port keeps its own copy of ``boxmot_tpu/trackers/sam2mot.py`` on its own
``BaseTracker``.  The same frames go through both trackers, with and without
segmentation masks, and the rows and masks must be identical; both sam2mot
pins hold through ``run_eval(device="cpu")``; and ``run_eval`` over a
detection and mask cache gives the JAX ``run_eval``'s metrics.
"""

from __future__ import annotations

import numpy as np
import pytest

from boxmot_tpu.engine.eval import run_eval as jax_run_eval
from boxmot_tpu.trackers.sam2mot import Sam2Mot as JaxSam2Mot
from boxmot_tpu_torch import create_tracker, run_eval
from boxmot_tpu_torch.data.cache import det_cache_path, mask_cache_path, pack_masks
from boxmot_tpu_torch.data.mot import MOTDataset
from boxmot_tpu_torch.engine import eval as teval
from boxmot_tpu_torch.trackers.sam2mot import Sam2Mot
from chip_smoke import occlusion_frames
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_host import assert_identical

IMG = np.zeros((1080, 1920, 3), np.uint8)
QUARTER = (270, 480)  # masks at a quarter of the frame's size


def _box_masks(dets, hw=QUARTER, scale=0.25):
    masks = np.zeros((len(dets), *hw), np.uint8)
    for i, b in enumerate(dets[:, :4] * scale):
        masks[i, max(int(b[1]), 0):int(b[3]), max(int(b[0]), 0):int(b[2])] = 1
    return masks


@pytest.mark.parametrize("with_masks", [True, False], ids=["masks", "boxes"])
def test_live_update_equals_jax(with_masks):
    """occlusion_frames (tracks lost and found, low confidences), with box
    masks at a quarter of the frame's size or without masks: rows, output
    masks and the track states equal."""
    frames, _ = occlusion_frames(40, 12, seed=21)
    jt, tt = JaxSam2Mot(), create_tracker("sam2mot", device="cpu")
    assert isinstance(tt, Sam2Mot)
    rows = masked = 0
    for f, dets in enumerate(frames):
        kw = {"masks": _box_masks(dets)} if with_masks else {}
        want, got = jt.update(dets, IMG, **kw), tt.update(dets, IMG, **kw)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f"frame {f}")
        assert (got.masks is None) == (want.masks is None)
        if want.masks is not None:
            np.testing.assert_array_equal(got.masks, want.masks)
            masked += 1
        rows += len(got)
        assert [(t.id, t.state, t.lost_frames) for t in tt._tracks] == [
            (t.id, t.state, t.lost_frames) for t in jt._tracks]
    assert rows > 200
    assert (masked > 0) == with_masks


def test_device_is_taken_and_ignored():
    """sam2mot runs on the host whatever ``device`` says; the zoo passes it."""
    tt = create_tracker("sam2mot", device="cuda:3")
    assert tt.device.type == "cpu"
    dets = np.array([[10, 10, 50, 90, 0.9, 0]], np.float32)
    assert tt.update(dets, IMG).shape == (1, 8)


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_sam2mot_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "sam2mot", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "sam2mot")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]


def test_run_eval_mask_cache_equals_jax(tmp_path, monkeypatch):
    """run_eval's host path over a detection cache and a mask cache (box masks
    packed at 160 x 160) of MOT17-mini: every metric equal to the JAX
    run_eval's, and the masks read for every sequence."""
    seqs = list(MOTDataset(ROOTS["mot17_mini"]))
    for seq in seqs:
        det_rows, mask_rows = [], []
        H, W = seq.info.im_height, seq.info.im_width
        for f, d in enumerate(seq.dets_per_frame(), start=1):
            if len(d):
                det_rows.append(np.concatenate([np.full((len(d), 1), f), d[:, :6]], 1))
                mask_rows.append(pack_masks(f, _box_masks(d, (H, W), 1.0)))
        for path, rows in ((det_cache_path(tmp_path, "det", seq.name), det_rows),
                           (mask_cache_path(tmp_path, "det", seq.name), mask_rows)):
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, np.concatenate(rows).astype(np.float32))
    loads = []
    real = teval.load_cached_masks_per_frame
    monkeypatch.setattr(teval, "load_cached_masks_per_frame",
                        lambda *a: loads.append(a[0]) or real(*a))
    got = run_eval(ROOTS["mot17_mini"], "sam2mot", device="cpu", cache_root=tmp_path, detector="det")
    want = jax_run_eval(ROOTS["mot17_mini"], "sam2mot", cache_root=tmp_path, detector="det")
    assert_identical(dict(got), dict(want))
    assert len(loads) == len(seqs)

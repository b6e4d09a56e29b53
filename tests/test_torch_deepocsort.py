"""The port's DeepOCSORT against the JAX package and its pins.

The same numpy inputs go through the JAX functions and their PyTorch
counterparts:

* ``deepocsort_step`` frame by frame, S = 2 sequences at once (the JAX step
  vmapped over S), from JAX states carried across, with seeded embeddings
  (feat_dim 32), non-identity warps and a share of detections missed, so
  that tracks rejoin and the ORU (``ops.oru``, kernel K4's twin) replays;
  with the adaptive weighting on, and with it off on GIoU.  Ids, masks,
  lifecycle counters and ``det_ind`` exact; means and covariances at rtol
  1e-4 with a floor of 1e-4 times each slot's largest entry; observations
  (warped every frame) and boxes at atol 1e-3 px; velocities at atol 1e-3;
  embeddings at atol 1e-6;
* ``aw_max_metric`` and ``_apply_affine``;
* both DeepOCSORT pins, and the live tracker with embeddings against the
  JAX one.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxmot_tpu
from boxmot_tpu.configs import get_tracker_defaults as jax_defaults
from boxmot_tpu.engine.eval import build_replay_config as jax_build_replay_config
from boxmot_tpu.trackers import deepocsort as jd
from boxmot_tpu_torch import create_tracker, run_eval
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import pack_embs, pack_frames, pack_warps
from boxmot_tpu_torch.ops import oru
from boxmot_tpu_torch.trackers import deepocsort as td
from chip_smoke import appearance_frames
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_botsort import assert_reid_model_rule
from tests.test_torch_bytetrack import _public_frames

ASSETS = Path(__file__).resolve().parent.parent / "assets"
RTOL = 1e-4
F32 = np.float32
S, K, D, FEAT, N_FRAMES = 2, 48, 32, 32, 40
EXACT = ("active", "age", "tsu", "hits", "hit_streak", "tid", "det_ind", "cls", "conf",
         "has_obs", "ring_age", "observed", "frame_count", "next_id")
BASE = dict(capacity=K, feat_dim=FEAT, det_thresh=0.5, w_association_emb=0.75)
VARIANTS = {"aw": BASE, "aw-off-giou": dict(BASE, aw_off=True, asso_func="giou", delta_t=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(jd.DeepOcSortState)}


def _close(got, want, live):
    """Means and covariances of live slots at rtol 1e-4, with an absolute
    floor of 1e-4 times each slot's largest entry."""
    if not live.any():
        return
    g, w = got[live], want[live]
    scale = np.abs(w).reshape(len(w), -1).max(axis=1).reshape((-1,) + (1,) * (w.ndim - 1))
    np.testing.assert_array_less(np.abs(g - w), RTOL * np.abs(w) + RTOL * scale + 1e-12)


def _scenes():
    """The panning appearance scene with 15 % of detections missed, and
    MOT17-04's public detections with every third frame thinned and
    embeddings that follow the detection order; translation and small
    rotation warps."""
    rng = np.random.default_rng(12)
    frames0, e0, w0 = appearance_frames(N_FRAMES, 24, seed=9, miss=0.15, feat_dim=FEAT)
    frames1 = [f.copy() for f in _public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 8) * 5]
    base = rng.normal(size=(32, FEAT))
    e1 = []
    for i, f in enumerate(frames1):
        keep = np.ones(len(f), bool) if i % 3 else rng.uniform(size=len(f)) > 0.4
        frames1[i] = f[keep]
        e1.append((base[:len(f)][keep] + rng.normal(0, 0.2, (int(keep.sum()), FEAT))).astype(F32))
    th = rng.normal(0, 0.003, N_FRAMES)
    w1 = np.zeros((N_FRAMES, 2, 3), F32)
    w1[:, 0, 0], w1[:, 0, 1], w1[:, 1, 0], w1[:, 1, 1] = np.cos(th), -np.sin(th), np.sin(th), np.cos(th)
    w1[:, :, 2] = rng.normal(0, 1.5, (N_FRAMES, 2))
    packed = np.stack([pack_frames(fr, D=D, F=N_FRAMES)[0] for fr in (frames0, frames1)])
    embs = np.stack([pack_embs(e, FEAT, D=D, F=N_FRAMES) for e in (e0, e1)])
    warps = np.stack([pack_warps(w, N_FRAMES) for w in (w0, w1)])
    return packed, embs, warps


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_frame_by_frame_equals_jax(variant):
    jcfg = jd.DeepOcSortConfig(**VARIANTS[variant])
    tcfg = td.DeepOcSortConfig(**dataclasses.asdict(jcfg))
    jstep = jax.jit(jax.vmap(lambda st, d, e, w: jd.deepocsort_step(jcfg, st, d, d[:, 4] >= 0, e, w)))
    packed, embs, warps = _scenes()
    jstate = jax.tree.map(lambda x: jnp.stack([x] * S), jd.init_state(jcfg))
    tstate = td.state_from_numpy(_jax_numpy(jstate), "cpu")
    rows = 0
    for f in range(N_FRAMES):
        jstate, jout, jmask = jstep(jstate, jnp.asarray(packed[:, f]), jnp.asarray(embs[:, f]),
                                    jnp.asarray(warps[:, f]))
        dets = torch.from_numpy(packed[:, f])
        tstate, tout, tmask = td.deepocsort_step(tcfg, tstate, dets, dets[..., 4] >= 0,
                                                 torch.from_numpy(embs[:, f]),
                                                 torch.from_numpy(warps[:, f]))
        got, want = td.state_to_numpy(tstate), _jax_numpy(jstate)
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        live = want["active"]
        for name in ("mean", "cov", "frozen_mean", "frozen_cov"):
            _close(got[name], want[name], live & want["has_obs"] if "frozen" in name else live)
        for name in ("last_obs", "obs_ring"):  # warped by the camera motion each frame
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-3, err_msg=name)
        # a unit direction between box centres that the warps move by an ulp
        # or two (about 1e-4 px): a few pixels apart, it turns by up to 1e-4
        np.testing.assert_allclose(got["velocity"], want["velocity"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["last_meas"], want["last_meas"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["emb"], want["emb"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask), err_msg=f"mask at {f}")
        tout, jout = tout.numpy(), np.asarray(jout)
        np.testing.assert_array_equal(tout[..., 4:], jout[..., 4:], err_msg=f"out at {f}")
        np.testing.assert_allclose(tout[..., :4], jout[..., :4], rtol=RTOL, atol=1e-3)
        rows += int(tmask.sum())
    assert int(tstate.lap_capped.sum()) == 0
    assert rows > 600
    assert int(tstate.oru_replayed.sum()) > 10  # tracks rejoined and the ORU replayed them
    assert np.abs(want["emb"]).sum() > 0


def test_aw_max_metric_and_affine_equal_jax():
    rng = np.random.default_rng(2)
    n, m = 40, 30
    cost = rng.uniform(-0.2, 1.0, (n, m)).astype(F32)
    cost[:5] = 0.0  # rows without a similarity
    cost[:, 7] = cost[:, 8]  # tied top two
    rows, cols = rng.uniform(size=n) < 0.8, rng.uniform(size=m) < 0.8
    want = jd.aw_max_metric(jnp.asarray(cost), 0.75, 0.5, jnp.asarray(rows), jnp.asarray(cols))
    got = td.aw_max_metric(torch.from_numpy(cost)[None], 0.75, 0.5, torch.from_numpy(rows)[None],
                           torch.from_numpy(cols)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    boxes = rng.uniform(0, 1000, (n, 4)).astype(F32)
    warp = np.array([[0.999, -0.02, 3.5], [0.02, 0.999, -2.25]], F32)
    np.testing.assert_allclose(td._apply_affine(torch.from_numpy(boxes)[None],
                                                torch.from_numpy(warp)[None])[0].numpy(),
                               np.asarray(jd._apply_affine(jnp.asarray(boxes), jnp.asarray(warp))),
                               rtol=1e-6, atol=1e-4)


def test_config_state_and_defaults_mirror_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(td.DeepOcSortConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(jd.DeepOcSortConfig)]
    assert td.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(jd.DeepOcSortState))
    assert oru.MAX_ORU == jd.MAX_ORU
    cfg = dict(capacity=16, delta_t=4, feat_dim=8)
    want = {k: np.stack([v] * 2) for k, v in _jax_numpy(jd.init_state(jd.DeepOcSortConfig(**cfg))).items()}
    got = td.state_to_numpy(td.init_state(td.DeepOcSortConfig(**cfg), 2, "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert get_tracker_defaults("deepocsort") == jax_defaults("deepocsort")
    for params in ({}, {"w_association_emb": 0.5, "iou_thresh": 0.5, "Q_xy_scaling": 0.2}):
        assert dataclasses.asdict(build_replay_config("deepocsort", **params)) == \
            dataclasses.asdict(jax_build_replay_config("deepocsort", **params))
    # iou_thresh is not a field: the replay keeps iou_threshold 0.3
    assert build_replay_config("deepocsort", iou_thresh=0.5).iou_threshold == 0.3
    kw = dict(delta_t=2, aw_off=True, Q_xy_scaling=0.1, cmc_off=True)
    jt, tt = boxmot_tpu.create_tracker("deepocsort", **kw), create_tracker("deepocsort", device="cpu", **kw)
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg) and tt.cmc is None
    assert_reid_model_rule("deepocsort", with_reid=False, **kw)


@pytest.mark.parametrize("with_embs", [True, False], ids=["embs", "ones"])
def test_live_update_equals_jax(with_embs):
    """The live tracker with embeddings given, and without (rows of ones,
    as the JAX tracker uses), CMC off; some frames thinned so OCR and the
    ORU run."""
    frames = _public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 24)
    rng = np.random.default_rng(5)
    base = rng.normal(size=(32, 512))
    kw = dict(capacity=64, cmc_off=True)
    jt, tt = boxmot_tpu.create_tracker("deepocsort", **kw), create_tracker("deepocsort", device="cpu", **kw)
    img = np.zeros((1080, 1920, 3), np.uint8)
    rows = 0
    for f, dets in enumerate(frames):
        keep = np.arange(len(dets)) >= (len(dets) // 3 if f % 6 == 4 else 0)
        dets = dets[keep]
        embs = (base[:len(keep)][keep] + rng.normal(0, 0.2, (len(dets), 512))).astype(F32) \
            if with_embs else None
        want = np.asarray(jt.update(dets, img, embs))
        got = np.asarray(tt.update(dets, img, embs))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
        rows += len(got)
    assert rows > 250
    assert int(tt._state.oru_replayed.sum()) > 0


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_deepocsort_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "deepocsort", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "deepocsort")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]

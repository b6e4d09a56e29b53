"""The port's BoostTrack against the JAX package and its pins, and the live
appearance trackers' per-class embeddings.

The same numpy inputs go through the JAX functions and their PyTorch
counterparts:

* ``boosttrack_step`` frame by frame, S = 2 sequences at once (the JAX step
  vmapped over S), from JAX states carried across, on three configurations
  that share one JAX compile each: the config defaults with appearance on
  (plain DLO and DUO boosts), the YAML tier without appearance (BoostTrack++'s
  rich similarity, soft-BIoU and varying threshold) and the YAML tier with
  appearance; seeded occluding identities (``chip_smoke.occlusion_frames``),
  embeddings of width 32 and translation + rotation + scale warps.  Ids,
  masks, lifecycle counters, ``cls`` and ``det_ind`` exact; confidences at
  rtol 1e-5 (the boosts read IoUs of the predicted boxes, and XLA on the CPU
  fuses multiply-adds that the port rounds apart, so the means differ in the
  last bits); means and covariances at rtol 1e-4 with a floor of 1e-4 times
  each slot's largest entry, but for tracks shrunk onto the filter's height
  floor, whose state is rounding noise (``close_means``); embeddings at
  atol 1e-6; emitted boxes at atol 1e-3 px;
* the pieces: the XYHR conversions, soft-BIoU, both shape similarities, the
  Mahalanobis distance and similarity, the track confidence, the camera
  update, the DLO boosts and DUO at rtol 1e-5;
* both BoostTrack pins, and the live tracker against the JAX one;
* with ``per_class`` and seeded embeddings, the live BoT-SORT, DeepOCSORT,
  BoostTrack and OccluBoost against the JAX shells, whose class banks all
  read the frame's first rows of ``embs``.
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
from boxmot_tpu.trackers import boosttrack as jbt
from boxmot_tpu_torch import create_tracker, run_eval
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import pack_embs, pack_frames, pack_warps
from boxmot_tpu_torch.trackers import boosttrack as tbt
from chip_smoke import occlusion_frames
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_botsort import _warps, assert_reid_model_rule
from tests.test_torch_bytetrack import _public_frames

ASSETS = Path(__file__).resolve().parent.parent / "assets"
RTOL = 1e-4
F32 = np.float32
S, K, D, FEAT, N_FRAMES = 2, 48, 32, 32, 50
EXACT = ("active", "age", "tsu", "hit_streak", "tid", "cls", "det_ind", "frame_count", "next_id")
FIELDS = {f.name for f in dataclasses.fields(jbt.BoostTrackConfig)}
YAML = {k: v for k, v in jax_defaults("boosttrack").items() if k in FIELDS}
BASE = dict(capacity=K, feat_dim=FEAT, max_age=8)
VARIANTS = {
    "defaults-reid": dict(BASE, with_reid=True),
    "yaml-noreid": dict(YAML, **BASE, with_reid=False),
    "yaml-reid": dict(YAML, **BASE, with_reid=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_steps():
    """One jitted, S-vmapped JAX step per variant, compiled once per module."""
    steps = {}
    for name, kw in VARIANTS.items():
        cfg = jbt.BoostTrackConfig(**kw)
        steps[name] = (cfg, jax.jit(jax.vmap(
            lambda st, d, e, w, cfg=cfg: jbt.boosttrack_step(cfg, st, d, d[:, 4] >= 0, e, w))))
    return steps


def scenes(obb=False, seed=30):
    """S packed occlusion scenes (S, F, D, 7 or 8), their embeddings
    (S, F, D, FEAT) and warps (S, F, 2, 3)."""
    rng = np.random.default_rng(seed)
    packed, embs, warps = [], [], []
    cols = 7 if obb else 6
    for s in range(S):
        frames, e = occlusion_frames(N_FRAMES, 14, seed=seed + s, feat_dim=FEAT, obb=obb)
        packed.append(pack_frames(frames, D=D, F=N_FRAMES, det_cols=cols)[0])
        embs.append(pack_embs(e, FEAT, D=D, F=N_FRAMES))
        warps.append(pack_warps(_warps(rng, N_FRAMES, euclidean=obb), N_FRAMES))
    return np.stack(packed), np.stack(embs), np.stack(warps)


def close_states(got, want, live):
    """Means and covariances of live slots at rtol 1e-4, with an absolute
    floor of 1e-4 times each slot's largest entry."""
    if not live.any():
        return
    g, w = got[live], want[live]
    scale = np.abs(w).reshape(len(w), -1).max(axis=1).reshape((-1,) + (1,) * (w.ndim - 1))
    np.testing.assert_array_less(np.abs(g - w), RTOL * np.abs(w) + RTOL * scale + 1e-12)


def close_means(got, want, live):
    """``close_states`` on XYHR means, for the live slots whose height is
    above the filter's 1e-4 floor: a track that has shrunk onto the floor has
    a box far below the float32 resolution of its position, so the camera
    update rebuilds its r from rounding noise, in both packages (it can never
    be emitted or matched)."""
    close_states(got, want, live & (want[..., 2] > 1e-3))


def jax_numpy(state, names):
    return {name: np.asarray(getattr(state, name)) for name in names}


def check_outputs(tout, tmask, jout, jmask, B, f):
    """Masks, ids, cls and det_ind exact, conf at rtol 1e-5; the emitted
    boxes at 1e-3 px."""
    np.testing.assert_array_equal(tmask, jmask, err_msg=f"mask at {f}")
    np.testing.assert_array_equal(tout[..., [B, B + 2, B + 3]], jout[..., [B, B + 2, B + 3]],
                                  err_msg=f"out at {f}")
    np.testing.assert_allclose(tout[..., B + 1], jout[..., B + 1], rtol=1e-5, atol=0)
    np.testing.assert_allclose(tout[jmask][:, :B], jout[jmask][:, :B], rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_frame_by_frame_equals_jax(variant, jax_steps):
    jcfg, jstep = jax_steps[variant]
    tcfg = tbt.BoostTrackConfig(**dataclasses.asdict(jcfg))
    packed, embs, warps = scenes()
    jstate = jax.tree.map(lambda x: jnp.stack([x] * S), jbt.init_state(jcfg))
    tstate = tbt.state_from_numpy(tbt.BoostTrackState, jax_numpy(jstate, tbt.JAX_FIELDS), "cpu")
    rows = died = 0
    for f in range(N_FRAMES):
        jstate, jout, jmask = jstep(jstate, jnp.asarray(packed[:, f]), jnp.asarray(embs[:, f]),
                                    jnp.asarray(warps[:, f]))
        dets = torch.from_numpy(packed[:, f])
        e = torch.from_numpy(embs[:, f]) if jcfg.with_reid else None
        before = tstate.active
        tstate, tout, tmask = tbt.boosttrack_step(tcfg, tstate, dets, dets[..., 4] >= 0, e,
                                                  torch.from_numpy(warps[:, f]))
        got = tbt.state_to_numpy(tstate, tbt.JAX_FIELDS)
        want = jax_numpy(jstate, tbt.JAX_FIELDS)
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        np.testing.assert_allclose(got["conf"], want["conf"], rtol=1e-5, atol=0)
        live = want["active"]
        close_means(got["mean"], want["mean"], live)
        close_states(got["cov"], want["cov"], live & (want["mean"][..., 2] > 1e-3))
        if jcfg.with_reid:
            np.testing.assert_allclose(got["emb"], want["emb"], rtol=0, atol=1e-6)
        check_outputs(tout.numpy(), tmask.numpy(), np.asarray(jout), np.asarray(jmask), 4, f)
        rows += int(tmask.sum())
        died += int((before & ~tstate.active).sum())
    assert int(tstate.lap_capped.sum()) == 0
    assert rows > 500 and died > 5  # the scenes track, and tracks age out


def _boxes(rng, n):
    xy = rng.uniform(0, 1800, (n, 2))
    wh = rng.uniform(5, 200, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(F32)


PIECES = ("conversions", "soft_biou", "shape_similarity", "mh", "track_confidence",
          "camera_update", "dlo_boost", "duo")


@pytest.mark.parametrize("piece", PIECES)
def test_pieces_equal_jax(piece):
    """Each piece on seeded inputs at rtol 1e-5 (the port's exp and pow are
    correctly rounded, XLA's are within an ulp or two), masks exact."""
    rng = np.random.default_rng(PIECES.index(piece))
    nd, nk = 20, 16
    det = _boxes(rng, nd)
    trk = np.concatenate([det[:8] + rng.normal(0, 8, (8, 4)).astype(F32), _boxes(rng, nk - 8)])
    trk_conf = rng.uniform(0, 1, nk).astype(F32)
    T = lambda a: torch.from_numpy(np.array(a))[None]  # noqa: E731
    close = lambda g, w: np.testing.assert_allclose(g[0].numpy(), np.asarray(w),  # noqa: E731
                                                    rtol=1e-5, atol=1e-6)
    mean = np.concatenate([np.asarray(jbt.xyxy2xyhr(jnp.asarray(trk))),
                           rng.normal(0, 2, (nk, 4))], 1).astype(F32)
    a = rng.normal(0, 1, (nk, 8, 8)).astype(F32)
    cov = (a @ a.transpose(0, 2, 1) + 4 * np.eye(8)).astype(F32)
    active = rng.uniform(size=nk) < 0.8
    det_valid = rng.uniform(size=nd) < 0.9
    pair_valid = det_valid[:, None] & active[None, :]
    md = np.asarray(jbt.mh_distance(jnp.asarray(det), jnp.asarray(mean), jnp.asarray(cov), None))
    if piece == "conversions":
        obb = np.concatenate([rng.uniform(0, 900, (nd, 2)), rng.uniform(0, 90, (nd, 2)),
                              rng.uniform(-3, 3, (nd, 1))], 1).astype(F32)
        for jf, tf, x in ((jbt.xyhr2xyxy, tbt.xyhr2xyxy, mean), (jbt.xyxy2xyhr, tbt.xyxy2xyhr, det),
                          (jbt.obb2xyhr, tbt.obb2xyhr, obb), (jbt.xyhr2obb, tbt.xyhr2obb,
                                                              np.asarray(jbt.obb2xyhr(obb)))):
            close(tf(T(x)), jf(jnp.asarray(x)))
    elif piece == "soft_biou":
        close(tbt.soft_biou(T(det), T(trk), T(trk_conf)),
              jbt.soft_biou(jnp.asarray(det), None, jnp.asarray(trk), jnp.asarray(trk_conf)))
    elif piece == "shape_similarity":
        for corr in (False, True):
            close(tbt.shape_similarity(T(det), T(trk), corr),
                  jbt.shape_similarity(jnp.asarray(det), jnp.asarray(trk), corr))
    elif piece == "mh":
        close(tbt.mh_distance(T(det), T(mean), T(cov)), md)
        md_mix = np.where(rng.uniform(size=md.shape) < 0.5, md, rng.uniform(0, 20, md.shape))
        md_mix = md_mix.astype(F32)
        close(tbt.mh_similarity(T(md_mix), T(pair_valid)),
              jbt.mh_similarity(jnp.asarray(md_mix), jnp.asarray(pair_valid)))
    elif piece == "track_confidence":
        age = rng.integers(0, 12, nk).astype(np.int32)
        tsu = rng.integers(1, 40, nk).astype(np.int32)
        close(tbt.track_confidence(T(age), T(tsu), T(active)),
              jbt.track_confidence(jnp.asarray(age), jnp.asarray(tsu), jnp.asarray(active)))
    elif piece == "camera_update":
        warp = _warps(rng, 1, euclidean=False)[0]
        close(tbt.camera_update_xyhr(T(mean), T(warp), T(active)),
              jbt.camera_update_xyhr(jnp.asarray(mean), jnp.asarray(warp), jnp.asarray(active)))
    else:
        conf = np.where(det_valid, rng.uniform(0.1, 0.9, nd), -1).astype(F32)
        tsu = rng.integers(1, 4, nk).astype(np.int32)
        iou = np.asarray(jbt._iou(jnp.asarray(det), jnp.asarray(trk)))
        if piece == "duo":
            md_far = np.where(rng.uniform(size=md.shape) < 0.7, 20.0, md).astype(F32)
            cfg = jbt.BoostTrackConfig()
            jc = jbt.duo_boost(cfg, jnp.asarray(conf), jnp.asarray(det_valid),
                               jnp.asarray(md_far), jnp.asarray(pair_valid), jnp.asarray(active))
            tc = tbt.duo_boost(cfg, T(conf), T(det_valid), T(md_far), T(pair_valid), T(active))
            np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
            dup = det.copy()
            dup[1::2] = det[::2] + 3  # overlapping candidates
            close(tbt._duo_apply(cfg, T(conf), T(dup), tc),
                  jbt._duo_apply(cfg, jnp.asarray(conf), None, jnp.asarray(dup), jc))
            assert int(tc.sum()) > 2
            return
        for kw in ({}, dict(use_sb=True), dict(use_vt=True), dict(use_rich_s=True, use_sb=True,
                                                                 use_vt=True)):
            cfg = jbt.BoostTrackConfig(**kw)
            want = jbt.dlo_boost(cfg, jnp.asarray(conf), jnp.asarray(det_valid), jnp.asarray(det),
                                 jnp.asarray(trk), jnp.asarray(trk_conf), jnp.asarray(tsu),
                                 jnp.asarray(md), jnp.asarray(pair_valid))
            close(tbt.dlo_boost(cfg, T(conf), T(det_valid), T(det), T(trk), T(trk_conf), T(tsu),
                                T(md), T(pair_valid), T(iou)), want)


def test_config_state_and_defaults_mirror_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(tbt.BoostTrackConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(jbt.BoostTrackConfig)]
    assert tbt.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(jbt.BoostTrackState))
    cfg = dict(capacity=16, feat_dim=8)
    fresh = jax_numpy(jbt.init_state(jbt.BoostTrackConfig(**cfg)), tbt.JAX_FIELDS)
    want = {k: np.stack([v] * 2) for k, v in fresh.items()}
    got = tbt.state_to_numpy(tbt.init_state(tbt.BoostTrackConfig(**cfg), 2, "cpu"), tbt.JAX_FIELDS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert get_tracker_defaults("boosttrack") == jax_defaults("boosttrack")
    for params in ({}, {"with_reid": False, "det_thresh": 0.4, "use_cmc": False}):
        assert dataclasses.asdict(build_replay_config("boosttrack", **params)) == \
            dataclasses.asdict(jax_build_replay_config("boosttrack", **params))
    kw = dict(min_box_area=20, use_rich_s=True, use_cmc=False, max_age=40)
    jt, tt = boxmot_tpu.create_tracker("boosttrack", **kw), create_tracker("boosttrack",
                                                                            device="cpu", **kw)
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    assert tt.cmc is None and type(create_tracker("boosttrack", device="cpu").cmc).__name__ == "ECC"
    assert_reid_model_rule("boosttrack", with_reid=True, **kw)


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_boosttrack_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "boosttrack", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "boosttrack")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]


def textured(f, rng_seed=6):
    """A seeded textured frame that pans one pixel a frame."""
    texture = np.random.default_rng(rng_seed).uniform(0, 255, (280, 440, 3)).astype(np.uint8)
    return np.ascontiguousarray(texture[f % 3:f % 3 + 270, f:f + 400])


@pytest.mark.parametrize("name", ["boosttrack", "occluboost"])
def test_live_update_with_sof_equals_jax(name):
    """The live tracker with SOF on seeded textured frames (both shells
    estimate the same warps on the host) against JAX's; embeddings are not
    read without a ReID model, in both."""
    frames = _public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 20)
    rng = np.random.default_rng(6)
    kw = dict(capacity=64, cmc_method="sof")
    jt, tt = boxmot_tpu.create_tracker(name, **kw), create_tracker(name, device="cpu", **kw)
    rows = 0
    for f, dets in enumerate(frames):
        img = textured(f)
        embs = rng.normal(size=(len(dets), 512)).astype(F32)
        want = np.asarray(jt.update(dets, img, embs))
        got = np.asarray(tt.update(dets, img, embs))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got[:, [4, 6, 7]], want[:, [4, 6, 7]], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
        rows += len(got)
    assert rows > 100
    assert tt.update(None, img).shape == (0, 8)


SPEED = 40.0  # px a frame: IoUs between frames low enough that appearance decides matches
PER_CLASS = {"botsort": dict(use_cmc=False), "deepocsort": dict(cmc_off=True),
             "boosttrack": dict(use_cmc=False), "occluboost": dict(use_cmc=False)}


@pytest.mark.parametrize("name", list(PER_CLASS))
def test_live_per_class_embeddings_equal_jax(name):
    """Three classes with seeded embeddings, per_class on: every class bank
    reads the frame's first rows of ``embs``, as the JAX appearance trackers
    do (BoostTrack and OccluBoost read none without a ReID model).  For
    BoT-SORT, banks fed their own class's rows instead give other tracks."""
    frames, embs = occlusion_frames(30, 12, seed=3, feat_dim=512, speed=SPEED)
    kw = dict(PER_CLASS[name], per_class=True, nr_classes=3, capacity=32)
    jt = boxmot_tpu.create_tracker(name, **kw)
    tt, sliced = (create_tracker(name, device="cpu", **kw) for _ in range(2))
    run_class = sliced._run_class
    differs = rows = 0
    for f, (dets, e) in enumerate(zip(frames, embs)):
        want = np.asarray(jt.update(dets, None, e))
        got = np.asarray(tt.update(dets, None, e))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got[:, [4, 6, 7]], want[:, [4, 6, 7]], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
        sliced._run_class = lambda cls_id, d, _, dets=dets, e=e: run_class(
            cls_id, d, e[dets[:, 5] == cls_id])
        old = np.asarray(sliced.update(dets, None, e))
        differs += old.shape != got.shape or not np.array_equal(old[:, :5], got[:, :5])
        rows += len(got)
    assert rows > 100 and len(np.unique(frames[5][:, 5])) == 3
    if name == "botsort":  # DeepOCSORT's IoU gate decides every match of this scene
        assert differs > 0

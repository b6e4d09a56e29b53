"""The port's BoT-SORT (AABB and OBB) against the JAX package and its pins.

The same numpy inputs go through the JAX functions and their PyTorch
counterparts:

* ``botsort_step`` frame by frame, S = 2 sequences at once (the JAX step
  vmapped over S), from JAX states carried across, on three configurations
  that share one JAX compile each: AABB with appearance on and the fused
  first pass, AABB with appearance off and the plain IoU first pass, and
  OBB with appearance on; seeded random embeddings (feat_dim 32) and
  non-identity warps (translation, small rotation and scale for AABB,
  euclidean for OBB).  Ids, status, masks, lifecycle counters and
  ``det_ind`` exact; means and covariances at rtol 1e-4 with a floor of
  1e-4 times each slot's largest entry; ``smooth_feat`` at atol 1e-6;
  boxes at atol 1e-3;
* ``_vote_cls`` on tied votes (the first class wins, as ``jnp.argmax``);
* the CMC warps of the state (``_apply_warp``, ``_apply_warp_obb``);
* ``run_eval`` with ``reid`` and ``cmc_method`` over a seeded embedding and
  warp cache of synth-long, row for row against the JAX ``run_eval``;
* both BoT-SORT pins, ``run_eval_obb`` on the JAX package's mmot-mini value,
  and the live tracker against the JAX one.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxmot_tpu
from boxmot_tpu.configs import get_tracker_defaults as jax_defaults
from boxmot_tpu.engine.eval import build_replay_config as jax_build_replay_config
from boxmot_tpu.trackers import botsort as jb
from boxmot_tpu_torch import create_tracker, run_eval, run_eval_obb
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import pack_embs, pack_frames, pack_warps
from boxmot_tpu_torch.trackers import botsort as tb
from chip_smoke import REID, REID_DETECTOR, appearance_frames, reid_caches, synthetic_obb_frames
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_bytetrack import _public_frames
from tests.test_torch_obb import ATOL, JAX_OBB_EVAL, MMOT

ASSETS = Path(__file__).resolve().parent.parent / "assets"
RTOL = 1e-4
F32 = np.float32
S, K, D, FEAT, N_FRAMES = 2, 48, 32, 32, 40
EXACT = ("status", "activated", "tid", "conf", "cls", "det_ind", "frame_id", "start_frame",
         "tracklet_len", "has_feat", "cls_seen", "frame_count", "next_id")
# the YAML's thresholds, at the test's width
BASE = dict(capacity=K, feat_dim=FEAT, nr_classes=4, max_time_lost=30,
            **{k: v for k, v in jax_defaults("botsort").items()
               if k in {f.name for f in dataclasses.fields(jb.BotSortConfig)}})
VARIANTS = {
    "aabb-reid-fused": dict(BASE, with_reid=True, fuse_first_associate=True),
    "aabb-noreid-plain": dict(BASE, with_reid=False, fuse_first_associate=False),
    "obb-reid": dict(BASE, with_reid=True, is_obb=True),
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
        cfg = jb.BotSortConfig(**kw)
        conf_i = 5 if cfg.is_obb else 4
        steps[name] = (cfg, jax.jit(jax.vmap(
            lambda st, d, e, w, cfg=cfg, conf_i=conf_i: jb.botsort_step(
                cfg, st, d, d[:, conf_i] >= 0, e, w))))
    return steps


def _warps(rng, n, euclidean):
    """Per-frame (n, 2, 3) warps: a translation of a few px and a small
    rotation, with a small scale too unless ``euclidean``."""
    th = rng.normal(0, 0.004, n)
    sc = np.ones(n) if euclidean else 1 + rng.normal(0, 0.003, n)
    w = np.zeros((n, 2, 3), F32)
    w[:, 0, 0], w[:, 0, 1] = sc * np.cos(th), -sc * np.sin(th)
    w[:, 1, 0], w[:, 1, 1] = sc * np.sin(th), sc * np.cos(th)
    w[:, :, 2] = rng.normal(0, 2.0, (n, 2))
    return w


def _scenes(obb: bool):
    """S packed sequences (S, F, D, 7 or 8), embeddings (S, F, D, FEAT) and
    warps (S, F, 2, 3): AABB, the panning appearance scene and MOT17-04's
    public detections with random embeddings; OBB, two synthetic scenes with
    misses.  Confidences spread over both passes; classes 0-3 with ties."""
    rng = np.random.default_rng(11)
    packed, embs, warps = [], [], []
    for s in range(S):
        if obb:
            frames = synthetic_obb_frames(N_FRAMES, 16, seed=20 + s, miss=0.1)
            e = [rng.normal(size=(len(f), FEAT)).astype(F32) for f in frames]
        elif s == 0:
            frames, e, _ = appearance_frames(N_FRAMES, 24, seed=5, miss=0.1, feat_dim=FEAT)
        else:
            frames = [f.copy() for f in _public_frames(
                ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 8) * 5]
            e = [rng.normal(size=(len(f), FEAT)).astype(F32) for f in frames]
        cols = 7 if obb else 6
        for f in frames:
            f[:, cols - 2] = np.where(rng.uniform(size=len(f)) < 0.3,
                                      rng.uniform(0.15, 0.55, len(f)), f[:, cols - 2])
            f[:, cols - 1] = rng.integers(0, 4, len(f))
        packed.append(pack_frames(frames, D=D, F=N_FRAMES, det_cols=cols)[0])
        embs.append(pack_embs(e, FEAT, D=D, F=N_FRAMES))
        warps.append(pack_warps(_warps(rng, N_FRAMES, euclidean=obb), N_FRAMES))
    return np.stack(packed), np.stack(embs), np.stack(warps)


def _close(got, want, live):
    """Means and covariances of live slots at rtol 1e-4, with an absolute
    floor of 1e-4 times each slot's largest entry."""
    if not live.any():
        return
    g, w = got[live], want[live]
    scale = np.abs(w).reshape(len(w), -1).max(axis=1).reshape((-1,) + (1,) * (w.ndim - 1))
    np.testing.assert_array_less(np.abs(g - w), RTOL * np.abs(w) + RTOL * scale + 1e-12)


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(jb.BotSortState)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_frame_by_frame_equals_jax(variant, jax_steps):
    jcfg, jstep = jax_steps[variant]
    tcfg = tb.BotSortConfig(**dataclasses.asdict(jcfg))
    obb = jcfg.is_obb
    B = 5 if obb else 4
    packed, embs, warps = _scenes(obb)
    jstate = jax.tree.map(lambda x: jnp.stack([x] * S), jb.init_state(jcfg))
    tstate = tb.state_from_numpy(_jax_numpy(jstate), "cpu")
    rows = votes = 0
    for f in range(N_FRAMES):
        jstate, jout, jmask = jstep(jstate, jnp.asarray(packed[:, f]), jnp.asarray(embs[:, f]),
                                    jnp.asarray(warps[:, f]))
        dets = torch.from_numpy(packed[:, f])
        e = torch.from_numpy(embs[:, f]) if jcfg.with_reid else None
        tstate, tout, tmask = tb.botsort_step(tcfg, tstate, dets, dets[..., B] >= 0, e,
                                              torch.from_numpy(warps[:, f]))
        got, want = tb.state_to_numpy(tstate), _jax_numpy(jstate)
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        np.testing.assert_allclose(got["cls_scores"], want["cls_scores"], rtol=1e-6, atol=1e-6)
        live = want["status"] > 0
        _close(got["mean"], want["mean"], live)
        _close(got["cov"], want["cov"], live)
        np.testing.assert_allclose(got["smooth_feat"], want["smooth_feat"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask), err_msg=f"mask at {f}")
        tout, jout = tout.numpy(), np.asarray(jout)
        np.testing.assert_array_equal(tout[..., B:], jout[..., B:], err_msg=f"out at {f}")
        np.testing.assert_allclose(tout[..., :B], jout[..., :B], rtol=RTOL, atol=1e-3)
        rows += int(tmask.sum())
        votes += int((want["cls_seen"].sum(-1) > 1).sum())
    assert int(tstate.lap_capped.sum()) == 0
    assert rows > (300 if obb else 500) and votes > 20  # the scenes track; tracks see several classes
    if jcfg.with_reid:
        assert want["has_feat"].sum() > 20
        assert np.abs(want["smooth_feat"]).sum() > 0


def test_vote_cls_ties_take_the_first_class():
    """Tied confidence-weighted votes: argmax takes the first class, as JAX."""
    rng = np.random.default_rng(3)
    n, nc = 64, 5
    scores = np.round(rng.uniform(0, 2, (n, nc)) * 4).astype(F32) / 4  # quarter steps: ties
    seen = rng.uniform(size=(n, nc)) < 0.6
    cls_det = rng.integers(-1, nc + 1, n).astype(F32)  # out-of-range classes clip
    conf = np.round(rng.uniform(0, 1, n) * 4).astype(F32) / 4
    mask = rng.uniform(size=n) < 0.8
    want = jb._vote_cls(jnp.asarray(scores), jnp.asarray(seen), jnp.asarray(cls_det),
                        jnp.asarray(conf), jnp.asarray(mask), nc)
    got = tb._vote_cls(*(torch.from_numpy(a)[None] for a in (scores, seen, cls_det, conf, mask)),
                       nc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    new_scores = np.asarray(want[0])
    tied = (new_scores == new_scores.max(1, keepdims=True)).sum(1) > 1
    assert (tied & seen[np.arange(n), np.clip(cls_det, 0, nc - 1).astype(int)]).sum() > 3


@pytest.mark.parametrize("obb", [False, True], ids=["aabb", "obb"])
def test_state_warps_equal_jax(obb):
    rng = np.random.default_rng(4)
    n = 40
    dx = 10 if obb else 8
    mean = rng.normal(0, 5, (n, dx)).astype(F32)
    mean[:, :2] = rng.uniform(0, 1800, (n, 2))
    mean[:, 2:4] = rng.uniform(10, 200, (n, 2))
    if obb:
        mean[:, 4] = rng.uniform(-np.pi, np.pi, n)
    a = rng.normal(0, 1, (n, dx, dx)).astype(F32)
    cov = (a @ a.transpose(0, 2, 1)).astype(F32)
    mask = rng.uniform(size=n) < 0.7
    warp = _warps(rng, 1, euclidean=obb)[0]
    fn = jb._apply_warp_obb if obb else jb._apply_warp
    wm, wc = (np.asarray(x) for x in fn(jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(warp),
                                        jnp.asarray(mask)))
    tfn = tb._apply_warp_obb if obb else tb._apply_warp
    gm, gc = (x[0].numpy() for x in tfn(torch.from_numpy(mean)[None], torch.from_numpy(cov)[None],
                                        torch.from_numpy(warp)[None], torch.from_numpy(mask)[None]))
    np.testing.assert_array_equal(gm[~mask], mean[~mask])
    np.testing.assert_allclose(gm, wm, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=1e-4 * np.abs(wc).max())
    assert not np.allclose(gm[mask], mean[mask])


def test_config_state_and_defaults_mirror_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(tb.BotSortConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(jb.BotSortConfig)]
    assert tb.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(jb.BotSortState))
    for obb in (False, True):
        cfg = dict(capacity=16, is_obb=obb, feat_dim=8, nr_classes=3)
        want = {k: np.stack([v] * 2) for k, v in _jax_numpy(jb.init_state(jb.BotSortConfig(**cfg))).items()}
        got = tb.state_to_numpy(tb.init_state(tb.BotSortConfig(**cfg), 2, "cpu"))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
    assert get_tracker_defaults("botsort") == jax_defaults("botsort")
    for params in ({}, {"with_reid": False, "match_thresh": 0.5, "track_buffer": 90}):
        assert dataclasses.asdict(build_replay_config("botsort", **params)) == \
            dataclasses.asdict(jax_build_replay_config("botsort", **params))
    cfg = build_replay_config("botsort")
    # track_buffer is not a field: the replay keeps max_time_lost 30
    assert (cfg.max_time_lost, cfg.fuse_first_associate, cfg.with_reid) == (30, True, True)


def test_live_config_resolution_equals_jax():
    kw = dict(track_buffer=60, frame_rate=25, match_thresh=0.7, use_cmc=False)
    jt, tt = boxmot_tpu.create_tracker("botsort", **kw), create_tracker("botsort", device="cpu", **kw)
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    assert tt.cmc is None and jt.cmc is None
    assert type(create_tracker("botsort", device="cpu").cmc).__name__ == "SOF"  # the YAML's
    with pytest.raises(NotImplementedError, match="Slice 5"):
        create_tracker("botsort", device="cpu", reid_model=object())


def test_live_update_with_embeddings_equals_jax():
    """The live tracker with embeddings and SOF on seeded textured frames
    (both shells estimate the same warps on the host) against JAX's."""
    frames = _public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 20)
    rng = np.random.default_rng(6)
    texture = rng.uniform(0, 255, (280, 440, 3)).astype(np.uint8)
    kw = dict(capacity=64, cmc_method="sof")
    jt, tt = boxmot_tpu.create_tracker("botsort", **kw), create_tracker("botsort", device="cpu", **kw)
    rows = 0
    for f, dets in enumerate(frames):
        img = np.ascontiguousarray(texture[f % 3:f % 3 + 270, f:f + 400])
        embs = rng.normal(size=(len(dets), 512)).astype(F32)
        want = np.asarray(jt.update(dets, img, embs))
        got = np.asarray(tt.update(dets, img, embs))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
        rows += len(got)
    assert rows > 100
    assert tt.update(None, img).shape == (0, 8)


@pytest.fixture(scope="module")
def reid_cache(tmp_path_factory):
    """chip_smoke.py's seeded synth-long caches (detections, embeddings of
    width FEAT that follow the ground-truth identities, translation warps)."""
    return reid_caches(tmp_path_factory.mktemp("reidcache"), FEAT)


def test_run_eval_with_reid_and_cmc_equals_jax(reid_cache, tmp_path):
    """The whole slice: synth-long from the caches, embeddings and warps on,
    filtered by min_det_conf; rows against the JAX run_eval's."""
    from boxmot_tpu.engine.eval import run_eval as jax_run_eval

    kw = dict(cache_root=reid_cache, detector=REID_DETECTOR, reid=REID, cmc_method="ecc",
              min_det_conf=0.2, tracker_params={"feat_dim": FEAT, "capacity": 64})
    got = run_eval(ROOTS["synth_long"], "botsort", device="cpu", output_dir=tmp_path / "port", **kw)
    want = jax_run_eval(ROOTS["synth_long"], "botsort", output_dir=tmp_path / "jax", **kw)
    for k in ("HOTA", "MOTA", "IDF1"):
        assert abs(got["combined"][k] - want["combined"][k]) <= 1e-6, k
    for p in (tmp_path / "jax").glob("*.txt"):
        w = np.loadtxt(p, delimiter=",")
        g = np.loadtxt(tmp_path / "port" / p.name, delimiter=",")
        assert g.shape == w.shape and len(g) > 1000
        np.testing.assert_array_equal(g[:, [0, 1, 6, 7, 8]], w[:, [0, 1, 6, 7, 8]])
        assert np.abs(g[:, 2:6] - w[:, 2:6]).max() <= 1  # whole-pixel tlwh
    plain = run_eval(ROOTS["synth_long"], "botsort", device="cpu", **{
        k: v for k, v in kw.items() if k not in ("reid", "cmc_method")})
    assert plain["combined"]["IDF1"] != got["combined"]["IDF1"]  # embeddings and warps matter


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_botsort_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "botsort", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "botsort")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]


def test_run_eval_obb_botsort_reproduces_jax():
    res = run_eval_obb(MMOT, "botsort", device="cpu")
    for k, v in JAX_OBB_EVAL["botsort"].items():
        assert abs(float(res["combined"][k]) - v) <= ATOL, (k, res["combined"])
    assert math.isfinite(float(res["combined"]["HOTA"]))

"""The port's OccluBoost (AABB and OBB) against the JAX package and its pins.

The same numpy inputs go through the JAX functions and their PyTorch
counterparts:

* ``occluboost_step`` frame by frame, S = 2 sequences at once (the JAX step
  vmapped over S), from JAX states carried across, on three configurations
  that share one JAX compile each: axis-aligned with appearance, GTA (max_age
  8, so tracks are buried and resurrected) and the second pass on; the YAML
  tier without appearance; oriented with appearance, GTA and the second
  pass; on seeded occluding identities (``chip_smoke.occlusion_frames``) with
  embeddings of width 32 and translation + rotation + scale warps.  Ids,
  masks, lifecycle counters, confirmation, the AMS ring and count, the
  graveyard's slots, ids, frames and classes, the gap count and the gap rows'
  frames, ids and classes exact; confidences at rtol 1e-5 and means and
  covariances at rtol 1e-4 (see ``test_torch_boosttrack``); embeddings at
  atol 1e-6; graveyard and gap boxes at atol 1e-3 px; and the GP-smoothed
  gap rows of the final states (``flush_gta_rows``) at atol 1e-3 px;
* ``_ams_alpha`` and ``_ams_append`` exact, and ``smooth_gap_rows`` (numpy
  and scipy) against the JAX copy's scikit-learn regressor at atol 1e-6 px;
* both OccluBoost pins, ``run_eval_obb`` on the JAX package's mmot-mini
  value, the cache-fed eval with GTA (the configuration of
  ``tests/test_emb_cache_eval.py``) row for row against JAX's; the live
  oriented tracker against the replay, and the replay's final states.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxmot_tpu
from boxmot_tpu.configs import get_tracker_defaults as jax_defaults
from boxmot_tpu.engine.eval import build_replay_config as jax_build_replay_config
from boxmot_tpu.trackers import occluboost as job
from boxmot_tpu_torch import create_tracker, run_eval, run_eval_obb
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.eval_obb import mmot_obb_dets
from boxmot_tpu_torch.engine.replay import replay_sequences_outputs
from boxmot_tpu_torch.trackers import boosttrack as tbt
from boxmot_tpu_torch.trackers import occluboost as tob
from chip_smoke import REID, REID_DETECTOR, reid_caches
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_botsort import assert_reid_model_rule
from tests.test_torch_boosttrack import (
    FEAT,
    N_FRAMES,
    RTOL,
    S,
    check_outputs,
    close_means,
    close_states,
    jax_numpy,
    scenes,
)
from tests.test_torch_obb import MMOT

F32 = np.float32
K = 48
# the JAX package's run_eval_obb("occluboost") on mmot-mini
JAX_OBB_EVAL = {"HOTA": 0.612130, "MOTA": 0.584943, "IDF1": 0.669023}
EXACT = ("active", "age", "tsu", "hit_streak", "tid", "cls", "det_ind", "is_activated",
         "ams_ring", "ams_count", "g_valid", "g_frame", "g_cls", "g_gid", "gap_count",
         "frame_count", "next_id")
FIELDS = {f.name for f in dataclasses.fields(job.OccluBoostConfig)}
YAML = {k: v for k, v in jax_defaults("occluboost").items() if k in FIELDS}
GTA = dict(capacity=K, feat_dim=FEAT, with_reid=True, gta_enabled=True, max_age=8,
           gta_min_track_length=3, use_second_pass=True, second_pass_min_hits=2,
           recovery_appearance_thresh=0.9)
VARIANTS = {
    "aabb-reid-gta": GTA,
    "aabb-yaml-noreid": dict(YAML, capacity=K, feat_dim=FEAT, with_reid=False, max_age=8),
    "obb-reid-gta": dict(GTA, is_obb=True),
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
        cfg = job.OccluBoostConfig(**kw)
        ci = 5 if cfg.is_obb else 4
        steps[name] = (cfg, jax.jit(jax.vmap(
            lambda st, d, e, w, cfg=cfg, ci=ci: job.occluboost_step(cfg, st, d, d[:, ci] >= 0,
                                                                    e, w))))
    return steps


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_frame_by_frame_equals_jax(variant, jax_steps):
    jcfg, jstep = jax_steps[variant]
    tcfg = tob.OccluBoostConfig(**dataclasses.asdict(jcfg))
    obb = jcfg.is_obb
    B = 5 if obb else 4
    packed, embs, warps = scenes(obb)
    jstate = jax.tree.map(lambda x: jnp.stack([x] * S), job.init_state(jcfg))
    tstate = tbt.state_from_numpy(tob.OccluBoostState, jax_numpy(jstate, tob.JAX_FIELDS), "cpu")
    rows = 0
    for f in range(N_FRAMES):
        jstate, jout, jmask = jstep(jstate, jnp.asarray(packed[:, f]), jnp.asarray(embs[:, f]),
                                    jnp.asarray(warps[:, f]))
        dets = torch.from_numpy(packed[:, f])
        e = torch.from_numpy(embs[:, f]) if jcfg.with_reid else None
        w = None if obb else torch.from_numpy(warps[:, f])
        tstate, tout, tmask = tob.occluboost_step(tcfg, tstate, dets, dets[..., B] >= 0, e, w)
        got = tbt.state_to_numpy(tstate, tob.JAX_FIELDS)
        want = jax_numpy(jstate, tob.JAX_FIELDS)
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        for name in ("conf", "g_conf"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=0, err_msg=name)
        live = want["active"]
        close_means(got["mean"], want["mean"], live)
        close_states(got["cov"], want["cov"], live & (want["mean"][..., 2] > 1e-3))
        if jcfg.with_reid:  # without it neither step reads the embeddings
            for name in ("emb", "g_emb"):
                np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got["g_box"], want["g_box"], rtol=RTOL, atol=1e-3)
        np.testing.assert_array_equal(got["gap_rows"][..., [0, 1, 7, 8]],
                                      want["gap_rows"][..., [0, 1, 7, 8]])
        np.testing.assert_allclose(got["gap_rows"], want["gap_rows"], rtol=RTOL, atol=1e-3)
        check_outputs(tout.numpy(), tmask.numpy(), np.asarray(jout), np.asarray(jmask), B, f)
        rows += int(tmask.sum())
    assert int(tstate.lap_capped.sum()) == 0
    assert rows > (300 if obb else 500)
    if jcfg.gta_enabled:
        # tracks were buried and resurrected, with gap rows
        assert tstate.resurrections.min() > 2 and tstate.gap_count.min() > 10
        for s in range(S):
            want = job.flush_gta_rows(jax.tree.map(lambda x: x[s], jstate), 5.0)
            got = tob.flush_gta_rows(tstate, 5.0, index=s)
            assert got.shape == want.shape and len(got) > 10
            np.testing.assert_array_equal(got[:, [0, 1, 7, 8]], want[:, [0, 1, 7, 8]])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    else:
        assert tstate.resurrections.sum() == 0 and tstate.gap_count.sum() == 0


def test_ams_alpha_and_append_equal_jax():
    """AMS on seeded rings (counts below, at and past the ring's length) with
    centre and scale spikes and shrinking boxes: the gain scales and the
    appended ring exact; every branch of the gain is taken."""
    rng = np.random.default_rng(2)
    n, B = 400, 7
    ring = np.concatenate([rng.uniform(100, 900, (n, B, 2)), rng.uniform(20, 120, (n, B, 2))],
                          -1).astype(F32)
    count = rng.integers(0, 3 * B, n).astype(np.int32)
    cur = ring[np.arange(n), (count - 1) % B] + rng.normal(0, 3, (n, 4)).astype(F32)
    spike = rng.uniform(size=n) < 0.5
    cur[spike, :2] += rng.normal(0, 60, (int(spike.sum()), 2)).astype(F32)
    cur[spike, 2:] *= rng.uniform(0.3, 1.0, (int(spike.sum()), 1)).astype(F32)
    cur = np.abs(cur).astype(F32)
    mask = rng.uniform(size=n) < 0.6
    for cfg in (job.OccluBoostConfig(), job.OccluBoostConfig(ams_alpha0=0.8, ams_threshold=0.2,
                                                             ams_shrink_ratio=0.9)):
        want = np.asarray(job._ams_alpha(cfg, jnp.asarray(ring), jnp.asarray(count),
                                         jnp.asarray(cur)))
        got = tob._ams_alpha(cfg, *(torch.from_numpy(a)[None] for a in (ring, count, cur)))
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert len(np.unique(want)) == 3  # 1, alpha0 and their mean
    jr, jc = job._ams_append(jnp.asarray(ring), jnp.asarray(count), jnp.asarray(cur),
                             jnp.asarray(mask))
    tr, tc = tob._ams_append(*(torch.from_numpy(a)[None] for a in (ring, count, cur, mask)))
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))


@pytest.mark.parametrize("tau", [5.0, 14.757519908748044, 0.0])
def test_smooth_gap_rows_equals_jax(tau):
    """The numpy Gaussian-process mean against the JAX copy's scikit-learn
    regressor, on ids with 1 to 40 gap rows each."""
    rng = np.random.default_rng(int(tau))
    rows = []
    for tid, n in enumerate((1, 2, 3, 7, 40, 12), start=1):
        start = rng.integers(1, 200)
        frames = np.arange(start, start + n)
        box = rng.uniform(0, 900, 4) + np.cumsum(rng.normal(0, 3, (n, 4)), axis=0)
        rows.append(np.column_stack([frames, np.full(n, tid), box, np.full(n, 0.8),
                                     np.zeros(n), -np.ones(n)]))
    rows = np.concatenate(rows)
    rows = rows[rng.permutation(len(rows))]
    want = job.smooth_gap_rows(rows.copy(), tau)
    got = tob.smooth_gap_rows(rows.copy(), tau)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (tau == 0.0) == np.array_equal(got, rows)


def test_config_state_and_defaults_mirror_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(tob.OccluBoostConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(job.OccluBoostConfig)]
    assert tob.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(job.OccluBoostState))
    for obb in (False, True):
        cfg = dict(capacity=16, feat_dim=8, is_obb=obb)
        want = {k: np.stack([v] * 2) for k, v in
                jax_numpy(job.init_state(job.OccluBoostConfig(**cfg)), tob.JAX_FIELDS).items()}
        got = tbt.state_to_numpy(tob.init_state(tob.OccluBoostConfig(**cfg), 2, "cpu"),
                                 tob.JAX_FIELDS)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
    assert get_tracker_defaults("occluboost") == jax_defaults("occluboost")
    for params in ({}, {"with_reid": False, "gta_enabled": True, "is_obb": True}):
        assert dataclasses.asdict(build_replay_config("occluboost", **params)) == \
            dataclasses.asdict(jax_build_replay_config("occluboost", **params))
    kw = dict(ams_alpha0=1.7, confirm_hits=0, ams_buffer_size=1, use_cmc=False, max_age=40)
    jt = boxmot_tpu.create_tracker("occluboost", **kw)
    tt = create_tracker("occluboost", device="cpu", **kw)
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    assert tt.gta_smooth_tau == jt.gta_smooth_tau and tt.cmc is None
    assert type(create_tracker("occluboost", device="cpu").cmc).__name__ == "SOF"  # the YAML's
    assert_reid_model_rule("occluboost", with_reid=True, **kw)


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_occluboost_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "occluboost", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "occluboost")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]


def test_run_eval_obb_occluboost_reproduces_jax():
    res = run_eval_obb(MMOT, "occluboost", device="cpu")
    for k, v in JAX_OBB_EVAL.items():
        assert abs(float(res["combined"][k]) - v) <= 1e-4, (k, res["combined"])
    assert math.isfinite(float(res["combined"]["HOTA"]))


@pytest.fixture(scope="module")
def reid_cache(tmp_path_factory):
    """chip_smoke.py's seeded synth-long caches (detections, embeddings of
    width FEAT that follow the ground-truth identities, translation warps)."""
    return reid_caches(tmp_path_factory.mktemp("reidcache"), FEAT)


def test_cache_fed_eval_with_gta_equals_jax(reid_cache, tmp_path):
    """synth-long from the embedding and warp caches with GTA on, max_age 10
    and gta_min_track_length 3: metrics and rows equal to the JAX run_eval's,
    unequal to the motion-only run's; the replay's final states hold the gap
    rows GTA made."""
    from boxmot_tpu.engine.eval import run_eval as jax_run_eval

    params = {"feat_dim": FEAT, "gta_enabled": True, "max_age": 10, "gta_min_track_length": 3,
              "capacity": 64}
    kw = dict(cache_root=reid_cache, detector=REID_DETECTOR, reid=REID, cmc_method="ecc",
              tracker_params=params)
    got = run_eval(ROOTS["synth_long"], "occluboost", device="cpu", output_dir=tmp_path / "port",
                   **kw)
    want = jax_run_eval(ROOTS["synth_long"], "occluboost", output_dir=tmp_path / "jax", **kw)
    for k in ("HOTA", "MOTA", "IDF1"):
        assert abs(got["combined"][k] - want["combined"][k]) <= 1e-6, k
    for p in (tmp_path / "jax").glob("*.txt"):
        w = np.loadtxt(p, delimiter=",")
        g = np.loadtxt(tmp_path / "port" / p.name, delimiter=",")
        assert g.shape == w.shape and len(g) > 1000
        np.testing.assert_array_equal(g[:, [0, 1, 7, 8]], w[:, [0, 1, 7, 8]])
        assert np.abs(g[:, 2:7] - w[:, 2:7]).max() <= 1  # whole-pixel tlwh, conf rounded
    motion = run_eval(ROOTS["synth_long"], "occluboost", device="cpu",
                      **{**kw, "tracker_params": {**params, "with_reid": False}})
    assert any(abs(motion["combined"][k] - got["combined"][k]) > 1e-6 for k in ("HOTA", "IDF1"))


def test_live_obb_equals_the_replay():
    """Live (N, 7) mmot-mini frames (no CMC, no boosts) give, frame by frame,
    the rows of the replay of the same frames with the live tracker's config
    (the replay's step is held to JAX's above)."""
    rows = 0
    for seq, frames in mmot_obb_dets(MMOT).items():
        tt = create_tracker("occluboost", device="cpu", capacity=64)
        live = [np.asarray(tt.update(dets)) for dets in frames]
        assert tt.cfg.is_obb and tt.flush_gta().shape == (0, 9)  # GTA needs a ReID model
        outs, masks = replay_sequences_outputs(tt.cfg, [{"dets": frames}], device="cpu")[0]
        for f, got in enumerate(live):
            np.testing.assert_array_equal(got, outs[f][masks[f]], err_msg=f"{seq} frame {f}")
            rows += len(got)
    assert rows > 50


def test_replay_returns_final_states(reid_cache):
    """``replay_sequences_outputs(..., with_states=True)``: each sequence's
    final state, from which ``flush_gta_rows`` reads the gap rows; the rows
    lie in the gaps of tracks that the replay emitted."""
    from boxmot_tpu_torch.data.cache import (det_cache_path, emb_cache_path,
                                             load_cached_dets_per_frame,
                                             load_cached_embs_per_frame)
    from boxmot_tpu_torch.data.mot import MOTDataset

    seqs = [{"dets": load_cached_dets_per_frame(det_cache_path(reid_cache, REID_DETECTOR, q.name),
                                                q.seq_length)[:150],
             "embs": load_cached_embs_per_frame(emb_cache_path(reid_cache, REID_DETECTOR, REID,
                                                               q.name), q.seq_length)[:150]}
            for q in MOTDataset(ROOTS["synth_long"])]
    cfg = build_replay_config("occluboost", feat_dim=FEAT, gta_enabled=True, max_age=10,
                              gta_min_track_length=3, gta_interpolate=True, capacity=64)
    out = replay_sequences_outputs(cfg, seqs, device="cpu", with_states=True)
    n_rows = 0
    for outs, masks, state in out:
        assert state.mean.shape[0] == 1 and int(state.frame_count[0]) == len(outs)
        rows = tob.flush_gta_rows(state, 5.0)
        emitted = set(outs[masks][:, 4].astype(int))
        assert set(rows[:, 1].astype(int)) <= emitted and (rows[:, 8] == -1).all()
        n_rows += len(rows)
    assert n_rows > 0

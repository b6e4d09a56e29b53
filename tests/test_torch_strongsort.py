"""The port's StrongSORT against the JAX package and its pins.

The same numpy inputs go through the JAX functions and their PyTorch
counterparts:

* ``strongsort_step`` frame by frame, S = 2 sequences at once (the JAX step
  vmapped over S, one compile), on ``chip_smoke.occlusion_frames`` (identities
  that vanish and return, shrink spikes, low confidences) with seeded 32-d
  embeddings and non-identity warps, capacity 64 and a bank of 8: the gate
  rejects appearance matches and confirmed tracks missed by pass 1 go through
  pass 2.  Ids, statuses, counters, masks and ``det_ind`` exact; means and
  covariances at rtol 1e-4 with a floor of 1e-4 times each slot's largest
  entry (XLA contracts the camera update's and the cost's multiply-adds);
  features and the bank at atol 1e-6; boxes at atol 1e-3 px;
* the live tracker with embeddings, with and without ``per_class``;
* both StrongSORT pins through ``run_eval(device="cpu")``.
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
from boxmot_tpu.trackers import strongsort as js
from boxmot_tpu_torch import create_tracker, run_eval
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import pack_embs, pack_frames, pack_warps
from boxmot_tpu_torch.motion import kalman as tk
from boxmot_tpu_torch.trackers import strongsort as ts
from chip_smoke import occlusion_frames
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_botsort import assert_reid_model_rule

ASSETS = Path(__file__).resolve().parent.parent / "assets"
RTOL = 1e-4
F32 = np.float32
S, K, D, FEAT, BUDGET, N_FRAMES = 2, 64, 32, 32, 8, 60
EXACT = ("status", "hits", "age", "tsu", "tid", "conf", "cls", "det_ind", "has_feat", "bank_count",
         "frame_count", "next_id")
CFG = dict(capacity=K, feat_dim=FEAT, nn_budget=BUDGET, max_age=10, max_cos_dist=0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(js.StrongSortState)}


def _close(got, want, live):
    """Means and covariances of live slots at rtol 1e-4, with an absolute
    floor of 1e-4 times each slot's largest entry."""
    if not live.any():
        return
    g, w = got[live], want[live]
    scale = np.abs(w).reshape(len(w), -1).max(axis=1).reshape((-1,) + (1,) * (w.ndim - 1))
    np.testing.assert_array_less(np.abs(g - w), RTOL * np.abs(w) + RTOL * scale + 1e-12)


def _warps(rng, n):
    """Per-frame warps: a small rotation and a translation of a few px."""
    th = rng.normal(0, 0.003, n)
    w = np.zeros((n, 2, 3), F32)
    w[:, 0, 0], w[:, 0, 1], w[:, 1, 0], w[:, 1, 1] = np.cos(th), -np.sin(th), np.sin(th), np.cos(th)
    w[:, :, 2] = rng.normal(0, 1.5, (n, 2))
    return w


def _scenes():
    """Two occlusion scenes (S, F, D, 7), their embeddings and warps; in the
    second, every fifth frame swaps two detections' embeddings, so that
    appearance prefers a pair the motion gate rejects."""
    rng = np.random.default_rng(3)
    packed, embs, warps = [], [], []
    for s in range(S):
        frames, e = occlusion_frames(N_FRAMES, 14, seed=40 + s, feat_dim=FEAT, speed=3.0)
        if s == 1:
            for f in range(0, N_FRAMES, 5):
                if len(e[f]) > 1:
                    e[f][[0, 1]] = e[f][[1, 0]]
        packed.append(pack_frames(frames, D=D, F=N_FRAMES)[0])
        embs.append(pack_embs(e, FEAT, D=D, F=N_FRAMES))
        warps.append(pack_warps(_warps(rng, N_FRAMES), N_FRAMES))
    return np.stack(packed), np.stack(embs), np.stack(warps)


def test_step_frame_by_frame_equals_jax(monkeypatch):
    jcfg = js.StrongSortConfig(**CFG)
    tcfg = ts.StrongSortConfig(**dataclasses.asdict(jcfg))
    jstep = jax.jit(jax.vmap(lambda st, d, e, w: js.strongsort_step(jcfg, st, d, d[:, 4] >= 0, e, w)))
    # record the port's passes: the appearance cost, the gate, and each
    # assignment's rows, columns and r2c
    apps, gates, solves = [], [], []
    real_app, real_gate, real_solve = ts.appearance_cost, tk.gating_distance, ts._full_assignment
    monkeypatch.setattr(ts, "appearance_cost", lambda *a: apps.append(real_app(*a)) or apps[-1])
    monkeypatch.setattr(ts.kalman, "gating_distance",
                        lambda *a: gates.append(real_gate(*a)) or gates[-1])
    monkeypatch.setattr(ts, "_full_assignment",
                        lambda c, r, k, cap: solves.append((r, k, real_solve(c, r, k, cap)))
                        or solves[-1][2])
    packed, embs, warps = _scenes()
    jstate = jax.tree.map(lambda x: jnp.stack([x] * S), js.init_state(jcfg))
    tstate = ts.state_from_numpy(_jax_numpy(jstate), "cpu")
    rows = rejected = pass2_confirmed = 0
    for f in range(N_FRAMES):
        prev_status = tstate.status.clone()
        jstate, jout, jmask = jstep(jstate, jnp.asarray(packed[:, f]), jnp.asarray(embs[:, f]),
                                    jnp.asarray(warps[:, f]))
        dets = torch.from_numpy(packed[:, f])
        tstate, tout, tmask = ts.strongsort_step(tcfg, tstate, dets, dets[..., 4] >= 0,
                                                 torch.from_numpy(embs[:, f]),
                                                 torch.from_numpy(warps[:, f]))
        got, want = ts.state_to_numpy(tstate), _jax_numpy(jstate)
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        live = want["status"] != ts.EMPTY
        for name in ("mean", "cov"):
            _close(got[name], want[name], live)
        np.testing.assert_allclose(got["smooth"], want["smooth"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["bank"], want["bank"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask), err_msg=f"mask at {f}")
        tout, jout = tout.numpy(), np.asarray(jout)
        np.testing.assert_array_equal(tout[..., 4:], jout[..., 4:], err_msg=f"out at {f}")
        np.testing.assert_allclose(tout[..., :4], jout[..., :4], rtol=RTOL, atol=1e-3)
        rows += int(tmask.sum())
        # pass 1's pairs of a confirmed track whose appearance fits but whose
        # gate does not, and pass 2's matches of confirmed tracks
        (r1, k1, _), (r2, _, a2) = solves[-2:]
        pairs = r1[..., None] & k1[:, None, :]
        rejected += int((pairs & (gates[-1] > ts.CHI2_4) & (apps[-1] <= tcfg.max_cos_dist)).sum())
        pass2_confirmed += int((r2 & (prev_status == ts.CONFIRMED) & (a2 >= 0)).sum())
    assert int(tstate.lap_capped.sum()) == 0
    assert rows > 500
    assert rejected > 0  # the gate turned confirmed tracks' pairs away
    assert pass2_confirmed > 0  # confirmed tracks missed by pass 1 went through pass 2
    assert (want["bank_count"] > BUDGET).any()  # the bank wrapped


def test_appearance_cost_equals_jax():
    """The bank's least cosine distance, against the JAX expression (the
    gate is held in tests/test_torch_kalman.py)."""
    rng = np.random.default_rng(4)
    k, b, d, f = 12, 5, 9, 16
    bank = rng.normal(size=(k, b, f)).astype(F32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    count = rng.integers(0, 9, k).astype(np.int32)
    feat = rng.normal(size=(d, f)).astype(F32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    valid = np.arange(b)[None, :] < np.minimum(count, b)[:, None]
    cos_d = np.where(valid[:, :, None], 1.0 - np.einsum("kbf,df->kbd", bank, feat), np.inf).min(1)
    want = np.where(np.isfinite(cos_d), cos_d, js.INFTY)
    got = ts.appearance_cost(torch.from_numpy(bank)[None], torch.from_numpy(count)[None],
                             torch.from_numpy(feat)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (count == 0).any() and (got[count == 0] == ts.INFTY).all()


def test_config_state_and_defaults_mirror_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(ts.StrongSortConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(js.StrongSortConfig)]
    assert ts.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(js.StrongSortState))
    assert (ts.EMPTY, ts.TENTATIVE, ts.CONFIRMED, ts.INFTY, ts.CHI2_4) == (
        js.EMPTY, js.TENTATIVE, js.CONFIRMED, js.INFTY, js.CHI2_4)
    cfg = dict(capacity=16, nn_budget=4, feat_dim=8)
    want = {k: np.stack([v] * 2) for k, v in _jax_numpy(js.init_state(js.StrongSortConfig(**cfg))).items()}
    got = ts.state_to_numpy(ts.init_state(ts.StrongSortConfig(**cfg), 2, "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert get_tracker_defaults("strongsort") == jax_defaults("strongsort")
    for params in ({}, {"max_cos_dist": 0.25, "nn_budget": 50, "with_reid": False}):
        assert dataclasses.asdict(build_replay_config("strongsort", **params)) == \
            dataclasses.asdict(jax_build_replay_config("strongsort", **params))
    kw = dict(min_conf=0.3, n_init=2, nn_budget=20, max_age=12)
    jt, tt = boxmot_tpu.create_tracker("strongsort", **kw), create_tracker("strongsort", device="cpu", **kw)
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    assert type(tt.cmc).__name__ == type(jt.cmc).__name__ == "ECC"
    assert_reid_model_rule("strongsort", with_reid=False, **kw)


@pytest.mark.parametrize("per_class", [False, True], ids=["all-classes", "per-class"])
def test_live_update_equals_jax(per_class):
    """The live tracker with embeddings (the whole frame's, read as embs[:n]
    by every class bank), no image (no CMC); the lost-track mask too."""
    frames, embs = occlusion_frames(30, 10, seed=7, feat_dim=512)
    kw = dict(capacity=64, per_class=per_class, nr_classes=3, min_conf=0.2)
    jt, tt = boxmot_tpu.create_tracker("strongsort", **kw), create_tracker("strongsort", device="cpu", **kw)
    rows = 0
    for f, (dets, e) in enumerate(zip(frames, embs)):
        want = np.asarray(jt.update(dets, None, e))
        got = np.asarray(tt.update(dets, None, e))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
        rows += len(got)
        if not per_class:
            np.testing.assert_array_equal(tt._lost_mask(tt._state), jt._lost_mask(jt._state))
    assert rows > 100
    if per_class:
        assert len(tt._per_class_states) == 3


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_strongsort_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "strongsort", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "strongsort")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]

"""The port's HybridSORT against the JAX package and its pins.

The same numpy inputs go through the JAX functions and their PyTorch
counterparts:

* ``hybridsort_step`` frame by frame, S = 2 sequences at once (the JAX step
  vmapped over S, one compile per variant), on ``chip_smoke.occlusion_frames``
  and on a scene whose left half goes dark for 40 frames (gaps past
  ``MAX_ORU``, so the capped replay is held too), with seeded 32-d
  embeddings and non-identity warps, capacity 64 and a long-term bank of 8,
  in three variants: the YAML tier with ReID (EG, the long-term bank and
  its correction, ``adapfs``, DIoU, ``max_age`` 230), the YAML tier without
  ReID (the unique-candidate shortcut, K1's IoU), and with the BYTE pass
  and ``adapfs`` on.  Ids, masks, counters and ``det_ind`` exact, boxes and
  observations exact; means and covariances at rtol 1e-4 with a floor of
  1e-4 times each slot's largest entry; corner velocities at atol 1e-5;
  features and the bank at atol 1e-6;
* the ORU twin on XYSCR (``ops.oru``, kernel K4's twin) against the JAX
  loop of ``boxmot_tpu/trackers/hybridsort.py``;
* the live tracker (``tid + 1``) with and without ``per_class``;
* both HybridSORT pins through ``run_eval(device="cpu")``.
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
from boxmot_tpu.motion import kalman as jk
from boxmot_tpu.trackers import hybridsort as jh
from boxmot_tpu.trackers.ocsort import MAX_ORU
from boxmot_tpu_torch import create_tracker, run_eval
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import pack_embs, pack_frames, pack_warps
from boxmot_tpu_torch.ops import oru
from boxmot_tpu_torch.trackers import hybridsort as th
from chip_smoke import occlusion_frames, oru_inputs
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_botsort import assert_reid_model_rule

ASSETS = Path(__file__).resolve().parent.parent / "assets"
RTOL = 1e-4
F32 = np.float32
S, K, D, FEAT, BANK, N_FRAMES = 2, 64, 32, 32, 8, 72
EXACT = ("active", "age", "tsu", "hits", "hit_streak", "tid", "conf", "conf_pre", "cls", "det_ind",
         "last_obs", "has_obs", "obs_ring", "ring_age", "observed", "bank_count", "frame_count",
         "next_id")
SMALL = dict(capacity=K, feat_dim=FEAT, longterm_bank_length=BANK)
VARIANTS = {
    "yaml-reid": dict(SMALL),
    "yaml-noreid-iou": dict(SMALL, with_reid=False, asso_func="iou"),
    "byte-adapfs": dict(SMALL, use_byte=True, adapfs=True, with_longterm_reid=False,
                        max_age=30, delta_t=3, asso_func="giou"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _jax_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(jh.HybridSortState)}


def _close(got, want, live):
    """Means and covariances of live slots at rtol 1e-4, with an absolute
    floor of 1e-4 times each slot's largest entry."""
    if not live.any():
        return
    g, w = got[live], want[live]
    scale = np.abs(w).reshape(len(w), -1).max(axis=1).reshape((-1,) + (1,) * (w.ndim - 1))
    np.testing.assert_array_less(np.abs(g - w), RTOL * np.abs(w) + RTOL * scale + 1e-12)


def _warps(rng, n):
    th = rng.normal(0, 0.002, n)
    w = np.zeros((n, 2, 3), F32)
    w[:, 0, 0], w[:, 0, 1], w[:, 1, 0], w[:, 1, 1] = np.cos(th), -np.sin(th), np.sin(th), np.cos(th)
    w[:, :, 2] = rng.normal(0, 1.0, (n, 2))
    return w


def _scenes():
    """Two occlusion scenes (S, F, D, 7) with their embeddings and warps; in
    the second the left half of the frame goes dark for frames 12-51, so its
    tracks come back after 40 frames."""
    rng = np.random.default_rng(8)
    packed, embs, warps = [], [], []
    for s in range(S):
        frames, e = occlusion_frames(N_FRAMES, 14, seed=60 + s, feat_dim=FEAT, speed=1.0 + s)
        if s == 1:
            for f in range(12, 52):
                keep = frames[f][:, 2] > 960
                frames[f], e[f] = frames[f][keep], e[f][keep]
        packed.append(pack_frames(frames, D=D, F=N_FRAMES)[0])
        embs.append(pack_embs(e, FEAT, D=D, F=N_FRAMES))
        warps.append(pack_warps(_warps(rng, N_FRAMES), N_FRAMES))
    return np.stack(packed), np.stack(embs), np.stack(warps)


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_frame_by_frame_equals_jax(variant, scenes, monkeypatch):
    jcfg = jax_build_replay_config("hybridsort", **VARIANTS[variant])
    tcfg = th.HybridSortConfig(**dataclasses.asdict(jcfg))
    assert tcfg == build_replay_config("hybridsort", **VARIANTS[variant])
    jstep = jax.jit(jax.vmap(lambda st, d, e, w: jh.hybridsort_step(jcfg, st, d, d[:, 4] >= 0, e, w)))
    gaps = []  # the largest gap of a rejoining slot, each step
    real = th.oru_replay
    monkeypatch.setattr(th, "oru_replay", lambda *a: gaps.append(
        int(torch.where(a[7], a[8], 0).max())) or real(*a))
    packed, embs, warps = scenes
    jstate = jax.tree.map(lambda x: jnp.stack([x] * S), jh.init_state(jcfg))
    tstate = th.state_from_numpy(_jax_numpy(jstate), "cpu")
    rows = 0
    for f in range(N_FRAMES):
        jstate, jout, jmask = jstep(jstate, jnp.asarray(packed[:, f]), jnp.asarray(embs[:, f]),
                                    jnp.asarray(warps[:, f]))
        dets = torch.from_numpy(packed[:, f])
        tstate, tout, tmask = th.hybridsort_step(tcfg, tstate, dets, dets[..., 4] >= 0,
                                                 torch.from_numpy(embs[:, f]),
                                                 torch.from_numpy(warps[:, f]))
        got, want = th.state_to_numpy(tstate), _jax_numpy(jstate)
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        live = want["active"]
        for name in ("mean", "cov", "frozen_mean", "frozen_cov"):
            _close(got[name], want[name], live & want["has_obs"] if "frozen" in name else live)
        np.testing.assert_allclose(got["vel"], want["vel"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["last_meas"], want["last_meas"], rtol=1e-6, atol=1e-6)
        for name in ("smooth", "bank"):
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask), err_msg=f"mask at {f}")
        tout, jout = tout.numpy(), np.asarray(jout)
        np.testing.assert_array_equal(tout[..., 4:], jout[..., 4:], err_msg=f"out at {f}")
        np.testing.assert_allclose(tout[..., :4], jout[..., :4], rtol=RTOL, atol=1e-3)
        rows += int(tmask.sum())
    assert int(tstate.lap_capped.sum()) == 0
    assert rows > 600
    assert int(tstate.oru_replayed.sum()) > 10  # tracks rejoined and the ORU replayed them
    if jcfg.max_age > MAX_ORU:
        assert max(gaps) > MAX_ORU  # the capped replay
    if jcfg.with_reid:
        assert (want["bank_count"] > BANK).any() and np.abs(want["bank"]).sum() > 0


def _jax_oru(mean, cov, frozen_mean, frozen_cov, last_meas, z2, rejoin, gap):
    """The ORU block of boxmot_tpu/trackers/hybridsort.py:339-388, over K slots."""
    layout = jk.make_xyscr_layout()
    K = rejoin.shape[0]
    mean = jnp.where(rejoin[:, None], frozen_mean, mean)
    cov = jnp.where(rejoin[:, None, None], frozen_cov, cov)
    m1_ = last_meas
    w1 = jnp.sqrt(jnp.maximum(m1_[:, 2] * m1_[:, 4], 1e-12))
    h1 = jnp.sqrt(jnp.maximum(m1_[:, 2] / jnp.maximum(m1_[:, 4], 1e-12), 1e-12))
    w2 = jnp.sqrt(jnp.maximum(z2[:, 2] * z2[:, 4], 1e-12))
    h2 = jnp.sqrt(jnp.maximum(z2[:, 2] / jnp.maximum(z2[:, 4], 1e-12), 1e-12))
    gapf = jnp.maximum(gap.astype(jnp.float32), 1.0)
    dx_, dy_ = (z2[:, 0] - m1_[:, 0]) / gapf, (z2[:, 1] - m1_[:, 1]) / gapf
    dw_, dh_, dc_ = (w2 - w1) / gapf, (h2 - h1) / gapf, (z2[:, 3] - m1_[:, 3]) / gapf

    def body(i, carry):
        mean, cov = carry
        act_i = rejoin & (i <= gap)
        pmean_i, pcov_i = jk.predict(layout, mean, cov, act_i)
        mean = jnp.where(i > 1, pmean_i, mean)
        cov = jnp.where(i > 1, pcov_i, cov)
        fi = i.astype(jnp.float32)
        wi, hi = w1 + fi * dw_, h1 + fi * dh_
        zi = jnp.stack([m1_[:, 0] + fi * dx_, m1_[:, 1] + fi * dy_, jnp.maximum(wi * hi, 1e-6),
                        m1_[:, 3] + fi * dc_, jnp.maximum(wi / jnp.maximum(hi, 1e-12), 1e-6)], -1)
        return jk.update(layout, mean, cov, zi, jnp.zeros((K,)), act_i)

    n_steps = jnp.minimum(jnp.max(jnp.where(rejoin, gap, 0)), MAX_ORU).astype(jnp.int32)
    return jax.jit(lambda c: jax.lax.fori_loop(jnp.int32(1), n_steps + 1, body, c))((mean, cov))


@pytest.mark.parametrize("gap_max", [31, 40])
def test_oru_twin_on_xyscr_equals_jax_loop(gap_max):
    """K4's twin on the XYSCR layout against the JAX loop, half the slots
    rejoining with gaps up to 31 and past MAX_ORU: means and covariances at
    rtol 1e-4 (floored), the slots that do not rejoin untouched."""
    rng = np.random.default_rng(gap_max)
    layout, tensors, rejoin, gap = oru_inputs(rng, 1, 48, "xyscr", p_rejoin=0.5, gap_max=gap_max)
    assert layout.name == "xyscr" and int(gap[rejoin].max()) > (MAX_ORU if gap_max > 32 else 20)
    replayed = torch.zeros(1, dtype=torch.int32)
    got = oru.oru_replay(layout, *tensors, rejoin, gap, replayed)
    want = _jax_oru(*(jnp.asarray(t[0].numpy()) for t in (*tensors, rejoin, gap)))
    for g, w in zip(got, want):
        _close(g[0].numpy(), np.asarray(w), np.ones(48, bool))
    assert int(replayed) == int(rejoin.sum())
    keep = ~rejoin[0]
    np.testing.assert_array_equal(got[0][0][keep].numpy(), tensors[0][0][keep].numpy())
    np.testing.assert_array_equal(got[1][0][keep].numpy(), tensors[1][0][keep].numpy())
    # the c row of the replayed state follows the interpolated confidences
    assert not np.array_equal(got[0][0][~keep][:, 3].numpy(), tensors[2][0][~keep][:, 3].numpy())


def test_box_conversions_equal_jax():
    rng = np.random.default_rng(9)
    box = np.concatenate([rng.uniform(0, 1000, (64, 2)), np.zeros((64, 3))], 1).astype(F32)
    box[:, 2:4] = box[:, :2] + rng.uniform(0, 200, (64, 2))
    box[:, 4] = rng.uniform(0, 1, 64)
    box[:4, 2] = box[:4, 0]  # zero width
    np.testing.assert_allclose(th.bbox_to_z(torch.from_numpy(box)).numpy(),
                               np.asarray(jh.bbox_to_z(jnp.asarray(box))), rtol=1e-6, atol=1e-6)
    z = np.asarray(jh.bbox_to_z(jnp.asarray(box)))
    mean = np.concatenate([z, np.zeros((64, 4), F32)], 1)
    np.testing.assert_allclose(th.x_to_bbox(torch.from_numpy(mean)).numpy(),
                               np.asarray(jh.x_to_bbox(jnp.asarray(mean))), rtol=1e-6, atol=1e-3)


def test_config_state_and_defaults_mirror_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(th.HybridSortConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(jh.HybridSortConfig)]
    assert th.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(jh.HybridSortState))
    assert (th.CORNERS, th.CORNER_COLS) == (jh.CORNERS, jh.CORNER_COLS)
    cfg = dict(capacity=16, delta_t=4, feat_dim=8, longterm_bank_length=5)
    want = {k: np.stack([v] * 2) for k, v in _jax_numpy(jh.init_state(jh.HybridSortConfig(**cfg))).items()}
    got = th.state_to_numpy(th.init_state(th.HybridSortConfig(**cfg), 2, "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert get_tracker_defaults("hybridsort") == jax_defaults("hybridsort")
    for params in ({}, {"with_reid": False}, {"use_byte": True, "max_obs": 10, "cmc_method": "sof"}):
        assert dataclasses.asdict(build_replay_config("hybridsort", **params)) == \
            dataclasses.asdict(jax_build_replay_config("hybridsort", **params))
    for kw in ({}, {"with_reid": False, "use_byte": True, "delta_t": 2}):
        jt, tt = boxmot_tpu.create_tracker("hybridsort", **kw), create_tracker("hybridsort", device="cpu", **kw)
        assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
        assert type(tt.cmc).__name__ == type(jt.cmc).__name__ == "ECC"
    assert th.HybridSort._id_emit_offset == jh.HybridSort._id_emit_offset == 1
    assert_reid_model_rule("hybridsort", with_reid=True)


@pytest.mark.parametrize("per_class", [False, True], ids=["all-classes", "per-class"])
def test_live_update_equals_jax(per_class, caplog):
    """The live tracker from the zoo's YAML tier (ReID on, 512-d embeddings
    given, no image so no CMC; a long-term bank of 20), and with ReID on but
    no embeddings (constant features, one warning), emitting tid + 1, per
    class renumbered over the classes as the JAX shell does."""
    frames, embs = occlusion_frames(30, 10, seed=12, feat_dim=512)
    kw = dict(capacity=32, per_class=per_class, nr_classes=3, longterm_bank_length=20)
    for with_embs in (True, False):
        jt = boxmot_tpu.create_tracker("hybridsort", **kw)
        tt = create_tracker("hybridsort", device="cpu", **kw)
        rows, ids = 0, set()
        for f, (dets, e) in enumerate(zip(frames, embs)):
            e = e if with_embs else None
            want = np.asarray(jt.update(dets, None, e))
            got = np.asarray(tt.update(dets, None, e))
            assert got.shape == want.shape, f
            np.testing.assert_array_equal(got[:, 4:], want[:, 4:], err_msg=f"frame {f}")
            np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
            rows += len(got)
            ids |= set(got[:, 4].astype(int).tolist())
        assert rows > 100 and min(ids) == 1
        assert tt._warned_no_feats == (not with_embs)
    assert any("constant features" in r.message for r in caplog.records)


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_hybridsort_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "hybridsort", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "hybridsort")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]



def test_gated_final_chance_is_not_solved(monkeypatch):
    """The final chance of the frame after births: its rows are tracks born a
    frame earlier, whose last observation is the -1 placeholder.  DIoU
    against it puts a problem's costs within about 0.1 of each other unless
    a detection lies near the image's corner, and the gate then fails.  The
    step solves no problem whose gate fails (the JAX step solves it and
    discards every pair, so the matches are the same); solved, such problems
    run into the auction's iteration cap on these inputs."""
    from boxmot_tpu_torch.engine.replay import batch_replay, init_states
    from boxmot_tpu_torch.ops.lap import masked_assignment_plain
    from chip_smoke import appearance_batch

    cfg = build_replay_config("hybridsort", capacity=128)
    batch, embs, warps = appearance_batch(8, 2, 100, 0, 0.05, "cpu")
    solves, gates = [], []
    real_solve, real_gate = th._full_assignment, th._gate
    monkeypatch.setattr(th, "_full_assignment", lambda c, r, k, cap: solves.append(
        (c, r, k)) or real_solve(c, r, k, cap))
    monkeypatch.setattr(th, "_gate", lambda *a: gates.append(real_gate(*a)) or gates[-1])
    states, _, _ = batch_replay(cfg, init_states(cfg, 8, "cpu"), batch, None, embs, warps)
    assert int(states.lap_capped.sum()) == 0
    cost, rows, cols = solves[-1]  # the second frame's final chance
    off = ~gates[-1]
    assert off.sum() >= 4 and not rows[off].any()
    # the rows it would have solved: born on the first frame, unmatched on the second
    born = states.active & (states.age == 1) & (states.tsu == 1) & off[:, None]
    assert born.any()
    valid = born[:, :, None] & cols[:, None, :]
    some = valid.any(dim=(1, 2))
    hi = torch.where(some, torch.where(valid, cost, -float("inf")).amax(dim=(1, 2)), 0.0)
    lo = torch.where(some, torch.where(valid, cost, float("inf")).amin(dim=(1, 2)), 0.0)
    assert float((hi - lo).max()) < 0.15
    capped = torch.zeros(8, dtype=torch.int32)
    masked_assignment_plain(cost, born, cols, hi + torch.clamp_min(hi - lo, 1e-2) * 1e-2, capped)
    assert int(capped.sum()) > 0

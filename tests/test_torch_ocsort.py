"""The port's OC-SORT (AABB and OBB) against the JAX package and its pins.

The same numpy inputs go through the JAX functions and their PyTorch
counterparts:

* the XYSR conversions, bit-equal; the XYSR(-OBB) Kalman layout: initiate
  and predict bit-equal, update at rtol 1e-5 (its products are summed in
  another order than XLA's dots); ``align_obb_xysr`` at 1e-6 (``log``
  differs by an ulp between XLA and PyTorch);
* the association family, ``"iou"`` through kernel K1's twin with
  ``iou_batch``'s union clamp (bit-equal, on boxes whose union is below the
  TPU kernel's 1e-9 clamp too) and the rest at atol 1e-6;
* the ORU (``ops.oru.oru_replay_plain``, the twin of kernel K4) inside the
  step, through a 4-frame and a 24-frame occlusion;
* ``ocsort_step`` frame by frame, S sequences at once, from JAX states
  carried across: ids, masks, lifecycle counters and ``det_ind`` exact, means
  and covariances at rtol 1e-4 with a floor of 1e-4 times each slot's
  largest entry, boxes at atol 1e-3;
* ``run_eval`` on both pins, ``run_eval_obb`` on the JAX package's mmot-mini
  value, and the live tracker on (N, 6), per-class and (N, 7) detections.

The JAX step runs at the live trackers' resolution of the YAML defaults at
capacity 64, with 32 detection columns (AABB) and 64 (OBB), so the step
tests and the live tests share one JAX compile per mode.
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
from boxmot_tpu.motion import kalman as jk
from boxmot_tpu.ops import geometry as jgeo
from boxmot_tpu.ops import iou as jiou
from boxmot_tpu.ops.pallas_kernels import _fused_iou_cost_pallas
from boxmot_tpu.trackers import ocsort as jo
from boxmot_tpu_torch import create_tracker, run_eval, run_eval_obb
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.eval_obb import mmot_obb_dets
from boxmot_tpu_torch.engine.replay import pack_frames
from boxmot_tpu_torch.motion import kalman as tk
from boxmot_tpu_torch.ops import geometry as tgeo
from boxmot_tpu_torch.ops import iou as tiou
from boxmot_tpu_torch.ops import oru
from boxmot_tpu_torch.ops.fused_iou_cost import IOU_BATCH_EPS, fused_iou_cost, fused_iou_cost_plain
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou
from boxmot_tpu_torch.trackers import ocsort as to
from chip_smoke import k4_bound, k4_bytes, oru_inputs, synthetic_obb_frames
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_bytetrack import _public_frames
from tests.test_torch_obb import ATOL, JAX_OBB_EVAL, MMOT

ASSETS = Path(__file__).resolve().parent.parent / "assets"
RTOL = 1e-4
F32 = np.float32
EXACT = ("active", "age", "tsu", "hits", "hit_streak", "tid", "det_ind", "cls", "conf",
         "last_obs", "has_obs", "obs_ring", "ring_age", "observed", "frame_count", "next_id")
LIVE_KW = dict(capacity=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _live_cfgs(obb: bool):
    """The JAX and port step configs of the live trackers' defaults."""
    jcfg = dataclasses.replace(boxmot_tpu.create_tracker("ocsort", **LIVE_KW).cfg, is_obb=obb)
    return jo.OcSortConfig(**dataclasses.asdict(jcfg)), to.OcSortConfig(**dataclasses.asdict(jcfg))


def _xyxy(rng, n):
    b = np.zeros((n, 4), F32)
    b[:, :2] = rng.uniform(0, 1800, (n, 2))
    b[:, 2:] = b[:, :2] + rng.uniform(2, 200, (n, 2))
    return b


def _obbs(rng, n):
    b = np.zeros((n, 5), F32)
    b[:, :2] = rng.uniform(0, 1800, (n, 2))
    b[:, 2:4] = rng.uniform(2, 200, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_xysr_conversions_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    xyxy = _xyxy(rng, 400)
    # an empty slot, a unit box, zero width, zero height
    xyxy[:4] = [[0, 0, 0, 0], [0, 0, 1, 1], [5, 5, 5, 9], [3, 3, 9, 3]]
    z = np.array(jgeo.xyxy2xysr(jnp.asarray(xyxy)))
    np.testing.assert_array_equal(tgeo.xyxy2xysr(torch.from_numpy(xyxy)).numpy(), z)
    z[:2] = [[0, 0, 0, 0], [10, 10, -1, 2]]  # an empty state, a negative area
    np.testing.assert_array_equal(tgeo.xysr2xyxy(torch.from_numpy(z)).numpy(),
                                  np.asarray(jgeo.xysr2xyxy(jnp.asarray(z))))
    obb = _obbs(rng, 400)
    obb[:2, 2:4] = [[0, 5], [1e-9, 0]]  # clamped sizes
    zo = np.asarray(jgeo.obb2xysr(jnp.asarray(obb)))
    np.testing.assert_array_equal(tgeo.obb2xysr(torch.from_numpy(obb)).numpy(), zo)
    state = np.concatenate([zo, rng.normal(0, 1, (400, 4)).astype(F32)], 1)
    state[:1, :4] = 0.0
    np.testing.assert_array_equal(tgeo.xysr2obb(torch.from_numpy(state)).numpy(),
                                  np.asarray(jgeo.xysr2obb(jnp.asarray(state))))


@pytest.mark.parametrize("obb", [False, True], ids=["aabb", "obb"])
def test_xysr_kalman_layout_equals_jax(obb):
    rng = np.random.default_rng(1)
    K = 48
    kw = dict(obb=obb, q_xy_scaling=0.02, q_s_scaling=3e-4, q_a_scaling=5e-4)
    jl, tl = jk.make_xysr_layout(**kw), tk.make_xysr_layout(**kw)
    assert (tl.name, tl.dx, tl.dz, tl.motion_mat) == (jl.name, jl.dx, jl.dz, jl.motion_mat)
    box = _obbs(rng, K) if obb else _xyxy(rng, K)
    z = np.array((jgeo.obb2xysr if obb else jgeo.xyxy2xysr)(jnp.asarray(box)))
    jm, jc = jk.initiate(jl, jnp.asarray(z))
    tm, tc = tk.initiate(tl, torch.from_numpy(z))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    mask = rng.uniform(size=K) < 0.7
    # jitted, as the JAX step runs them
    j_predict = jax.jit(lambda m, c, k: jk.predict(jl, m, c, k))
    j_update = jax.jit(lambda m, c, z, k: jk.update(jl, m, c, z, jnp.zeros(K), k))
    for _ in range(3):
        jm, jc = j_predict(jm, jc, jnp.asarray(mask))
        tm, tc = tk.predict(tl, tm, tc, torch.from_numpy(mask))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        meas = (np.asarray(jm)[:, :tl.dz] * rng.uniform(0.97, 1.03, (K, tl.dz))).astype(F32)
        jm, jc = j_update(jm, jc, jnp.asarray(meas), jnp.asarray(mask))
        tm, tc = tk.update(tl, tm, tc, torch.from_numpy(meas), torch.from_numpy(mask))
        for i in range(K):
            for g, w in ((tm[i].numpy(), np.asarray(jm[i])), (tc[i].numpy(), np.asarray(jc[i]))):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
        # the next predict starts from the same bits on both sides
        tm, tc = torch.from_numpy(np.array(jm)), torch.from_numpy(np.array(jc))
    q_var, r_var = tk.const_noise(tl)
    np.testing.assert_array_equal(np.float32(q_var), np.square(np.float32(np.sqrt(
        [1.0] * tl.dz + [0.02, 0.02, 3e-4] + ([5e-4] if obb else [])))))
    assert len(r_var) == tl.dz


def test_align_obb_xysr_equals_jax():
    rng = np.random.default_rng(2)
    n = 400
    ref = np.array(jgeo.obb2xysr(jnp.asarray(_obbs(rng, n))))
    z = ref * rng.uniform(0.95, 1.05, (n, 5)).astype(F32)
    turn = rng.integers(0, 4, n)  # the same rectangle, parameterized four ways
    z[turn >= 2, 3] = 1.0 / z[turn >= 2, 3]
    z[:, 4] = ref[:, 4] + np.array([0, np.pi, np.pi / 2, -np.pi / 2], F32)[turn]
    z[:, 4] += rng.normal(0, 0.05, n).astype(F32)
    z[:5, 4] = [7.0, -7.0, np.pi, -np.pi, 0.0]  # wrapped first
    z[5:10, 2:4] = 0.0  # clamped at eps
    want = np.asarray(jk.align_obb_xysr(jnp.asarray(z), jnp.asarray(ref)))
    got = tk.align_obb_xysr(torch.from_numpy(z), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["iou", "hmiou", "giou", "diou", "ciou", "centroid"])
def test_association_family_equals_jax(name):
    rng = np.random.default_rng(3)
    a, b = _xyxy(rng, 40), _xyxy(rng, 30)
    b[:20] = a[:20] + rng.normal(0, 8, (20, 4)).astype(F32)
    a[:3] = [[0, 0, 0, 0], [0, 0, 1, 1], [-1, -1, -1, -1]]  # empty slot, padding, no observation
    want = np.asarray(jiou.get_asso_func(name, 1920.0, 1080.0)(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.get_asso_func(name, 1920.0, 1080.0)(torch.from_numpy(a)[None],
                                                   torch.from_numpy(b)[None])[0].numpy()
    if name == "iou":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want[3:20].max(axis=1) > 0.3).mean() > 0.5  # the pairs really overlap


def test_obb_association_equals_jax():
    """``"centroid_obb"`` against JAX; ``"iou_obb"`` resolves to kernel K3,
    whose twin tests/test_torch_obb.py holds to the JAX rotated IoU."""
    rng = np.random.default_rng(4)
    a, b = _obbs(rng, 24), _obbs(rng, 20)
    b[:12] = a[:12] + rng.normal(0, 2, (12, 5)).astype(F32)
    want = np.asarray(jiou.get_asso_func("centroid_obb", 640.0, 512.0)(a, b))
    got = tiou.get_asso_func("centroid_obb", 640.0, 512.0)(torch.from_numpy(a)[None],
                                                           torch.from_numpy(b)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert tiou.get_asso_func("iou_obb") is rotated_iou


def test_asso_func_names_and_errors_equal_jax():
    assert sorted(tiou.ASSO_FUNCS) == sorted(jiou.ASSO_FUNCS)
    assert sorted(tiou.ASSO_FUNCS_WH) == sorted(jiou.ASSO_FUNCS_WH)
    for mod in (tiou, jiou):
        with pytest.raises(ValueError, match="requires frame"):
            mod.get_asso_func("centroid")
        with pytest.raises(ValueError, match="Invalid association mode"):
            mod.get_asso_func("giou_obb")


def test_k1_union_clamp_equals_iou_batch_on_tiny_boxes():
    """Boxes whose union is below 1e-9: the tracker steps' IoU (K1 with
    iou_batch's clamp) equals the JAX iou_batch; the TPU kernel's clamp,
    K1's default, gives the TPU kernel's value."""
    trk = np.array([[[0, 0, 1e-5, 1e-5]]], F32)
    det = np.array([[[0, 0, 1e-5, 1e-5], [0, 0, 2e-5, 1e-5]]], F32)
    want = np.asarray(jiou.iou_batch(jnp.asarray(trk[0]), jnp.asarray(det[0])))
    np.testing.assert_allclose(want, [[1.0, 0.5]], rtol=1e-6)
    t, d = torch.from_numpy(trk), torch.from_numpy(det)
    for got in (fused_iou_cost_plain(t, d, eps=IOU_BATCH_EPS)[0],
                fused_iou_cost(t, d, eps=IOU_BATCH_EPS)[0], tiou.get_asso_func("iou")(t, d),
                tiou.iou_batch(t, d)):
        np.testing.assert_array_equal(got[0].numpy(), want)
    conf = torch.ones(1, 2)
    tpu_iou, tpu_cost = _fused_iou_cost_pallas(jnp.asarray(trk[0]), jnp.asarray(det[0]).T,
                                               jnp.ones((1, 2)), interpret=True)
    iou, cost = fused_iou_cost_plain(t, d, conf)
    np.testing.assert_array_equal(iou[0].numpy(), np.asarray(tpu_iou))
    np.testing.assert_array_equal(cost[0].numpy(), np.asarray(tpu_cost))
    assert not np.array_equal(iou[0].numpy(), want)  # the two clamps differ here
    with pytest.raises(ValueError, match="eps"):
        fused_iou_cost(t, d, eps=0.0)


def _jax_to_numpy(states):
    return {f.name: np.stack([np.asarray(getattr(s, f.name)) for s in states])
            for f in dataclasses.fields(jo.OcSortState)}


def _close(got, want, live):
    """Means and covariances of live slots at rtol 1e-4, with an absolute
    floor of 1e-4 times each slot's largest entry."""
    if not live.any():
        return
    g, w = got[live], want[live]
    scale = np.abs(w).reshape(len(w), -1).max(axis=1).reshape((-1,) + (1,) * (w.ndim - 1))
    np.testing.assert_array_less(np.abs(g - w), RTOL * np.abs(w) + RTOL * scale + 1e-12)


def _run_steps(jcfg, tcfg, packed):
    """Frame by frame, the JAX step per sequence and the port's batched step
    from the JAX initial states; returns (port state, emitted rows)."""
    S, n_frames = packed.shape[:2]
    conf_i = 5 if jcfg.is_obb else 4
    B = conf_i
    jstates = [jo.init_state(jcfg) for _ in range(S)]
    tstate = to.state_from_numpy(_jax_to_numpy(jstates), "cpu")
    rows = 0
    for f in range(n_frames):
        outs, masks = [], []
        for s in range(S):
            dets = jnp.asarray(packed[s, f])
            jstates[s], out, mask = jo.ocsort_step(jcfg, jstates[s], dets, dets[:, conf_i] >= 0)
            outs.append(np.asarray(out))
            masks.append(np.asarray(mask))
        dets = torch.from_numpy(packed[:, f])
        tstate, tout, tmask = to.ocsort_step(tcfg, tstate, dets, dets[..., conf_i] >= 0)
        got, want = to.state_to_numpy(tstate), _jax_to_numpy(jstates)
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        live = want["active"]
        for name in ("mean", "cov", "frozen_mean", "frozen_cov"):
            _close(got[name], want[name], live & want["has_obs"] if "frozen" in name else live)
        np.testing.assert_allclose(got["velocity"], want["velocity"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["last_meas"], want["last_meas"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tmask.numpy(), np.stack(masks), err_msg=f"mask at {f}")
        tout, jout = tout.numpy(), np.stack(outs)
        np.testing.assert_array_equal(tout[..., B:], jout[..., B:], err_msg=f"out at {f}")
        np.testing.assert_allclose(tout[..., :B], jout[..., :B], rtol=RTOL, atol=1e-3)
        rows += int(tmask.sum())
    assert int(tstate.lap_capped.sum()) == 0  # no solve stopped at the auction's cap
    return tstate, rows


def _occlusion_scene(n_frames, gone, step):
    """One box moving right, missing in frames ``gone``."""
    frames = []
    for f in range(n_frames):
        rows = [] if f in gone else [[50 + step * f, 100, 110 + step * f, 220, 0.9, 0.0]]
        frames.append(np.array(rows, F32).reshape(-1, 6))
    return frames


def test_oru_twin_equals_jax_through_occlusions():
    """The scene of tests/test_tracker_ocsort.py (4 missed frames) and a
    24-frame occlusion: the ORU replays on the rejoin frame, and the port's
    state, replayed by ``oru_replay_plain``, stays equal to the JAX step's."""
    jcfg, tcfg = _live_cfgs(False)
    scenes = [_occlusion_scene(25, range(10, 14), 6), _occlusion_scene(40, range(10, 34), 2)]
    packed = np.stack([pack_frames(s, D=32, F=40)[0] for s in scenes])
    state, rows = _run_steps(jcfg, tcfg, packed)
    assert state.oru_replayed.tolist() == [1, 1]  # one rejoin in each scene
    assert state.tid[:, 0].tolist() == [1, 1] and int(state.next_id.max()) == 2  # identity kept
    assert rows > 30


def test_oru_plain_replays_the_capped_gap_and_passes_other_slots_through():
    rng = np.random.default_rng(5)
    layout, tensors, rejoin, gap = oru_inputs(rng, 2, 12, obb=False, p_rejoin=0.5, gap_max=40)
    replayed = torch.zeros(2, dtype=torch.int32)
    mean, cov = oru.oru_replay(layout, *tensors, rejoin, gap, replayed)
    assert replayed.tolist() == rejoin.sum(dim=1).tolist() and int(rejoin.sum()) > 0
    assert torch.equal(mean[~rejoin], tensors[0][~rejoin])
    assert torch.equal(cov[~rejoin], tensors[1][~rejoin])
    assert not torch.equal(mean[rejoin], tensors[2][rejoin])
    assert int(gap.max()) > oru.MAX_ORU  # a gap past the cap replays MAX_ORU updates
    with pytest.raises(ValueError, match="XYSR"):
        oru.oru_replay(tk.make_xyah_layout(), *tensors, rejoin, gap, replayed)
    with pytest.raises(ValueError, match="int32"):
        oru.oru_replay(layout, *tensors, rejoin, gap.long(), replayed)


@pytest.mark.parametrize("obb", [False, True], ids=["aabb", "obb"])
def test_k4_bound_counts_every_slot_of_the_out_of_place_replay(obb):
    """K4 writes new (S, K, dx) and (S, K, dx, dx) outputs, so its bound
    reads and writes every slot's mean and covariance once, and only the
    rejoining slots' measurements and gaps; its operations are those of each
    rejoining slot's min(gap, MAX_ORU) updates and the predicts between."""
    from boxmot_tpu_torch.utils import measure
    from chip_smoke import _k4_predict_ops, _k4_update_ops
    layout = tk.make_xysr_layout(obb, 0.01, 1e-4, 1e-4)
    rejoin = torch.tensor([[True, False, True], [False, False, True]])
    gap = torch.tensor([[2, 7, 5], [9, 1, 40]], dtype=torch.int32)
    dx, dz = (9, 5) if obb else (7, 4)
    state = 4 * (dx + dx * dx)  # one slot's mean and covariance
    hand = 6 * (state + state + 1) + 3 * (4 * dz + 4 * dz + 4) + 2 * 4 * 2
    assert k4_bytes(layout, rejoin) == hand == (4474 if obb else 2818)
    updates = 2 + 5 + oru.MAX_ORU
    assert k4_bound(layout, rejoin, gap) == measure.bound_ms(
        hand, updates * _k4_update_ops(dx, dz) + (updates - 3) * _k4_predict_ops(dx))


@pytest.mark.parametrize("layout", ["xysr", "xysr_obb", "xyscr"], ids=["aabb", "obb", "xyscr"])
@pytest.mark.parametrize("S, K", [(8, 256), (3, 77), (1, 1)])
def test_k4_launch_geometry_is_a_warp_a_slot(S, K, layout):
    g = oru.launch_geometry(S, K, layout)
    warps = g.threads // 32
    assert g.threads % 32 == 0 and g.threads == oru.THREADS <= 128
    assert (g.blocks - 1) * warps < S * K <= g.blocks * warps  # every slot, no empty block
    nine = layout != "xysr"  # XYSR-OBB and XYSCR: 9 states, 5 measurements
    tile = 4 * (382 if nine else 246)  # csrc/oru.cu's Tile<9, 5> / Tile<7, 4>, counted by hand
    assert g.shared_bytes == warps * tile == warps * 4 * oru.tile_floats(*((9, 5) if nine else (7, 4)))
    assert g.shared_bytes <= 48 * 1024  # dynamic shared memory without an opt-in
    assert oru.LAYOUT_TAGS[layout][0] == ["xysr", "xysr_obb", "xyscr"].index(layout)


@pytest.mark.parametrize("variant", ["defaults", "byte-giou"])
def test_step_frame_by_frame_equals_jax(variant):
    """MOT17-04's public detections and a synth-long prefix, S = 2: with the
    live defaults (K1's IoU), and with the BYTE pass on, a higher detection
    threshold (so that low-confidence detections reach it) and GIoU."""
    n_frames = 50
    seqs = [_public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", n_frames),
            _public_frames(ASSETS / "synth-long/train/SYNTH-01", n_frames)]
    packed = np.stack([pack_frames(s, D=32, F=n_frames)[0] for s in seqs])
    jcfg, tcfg = _live_cfgs(False)
    if variant == "byte-giou":
        kw = dict(use_byte=True, det_thresh=0.8, asso_func="giou", delta_t=2)
        jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    _, rows = _run_steps(jcfg, tcfg, packed)
    assert rows > 600  # the prefixes really track


def test_obb_step_frame_by_frame_equals_jax():
    """The mmot-mini frames and two synthetic scenes with 10 % of the boxes
    missed each frame (so that the ORU runs), S = 4."""
    seqs = list(mmot_obb_dets(MMOT).values())
    seqs += [synthetic_obb_frames(16, 40, seed=s, miss=0.1) for s in (7, 8)]
    packed = np.stack([pack_frames(s, D=64, F=16, det_cols=7)[0] for s in seqs])
    state, rows = _run_steps(*_live_cfgs(True), packed)
    assert rows > 300
    assert int(state.oru_replayed[2:].sum()) > 5  # the synthetic scenes rejoin tracks


def test_config_and_state_mirror_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(to.OcSortConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(jo.OcSortConfig)]
    assert to.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(jo.OcSortState))
    assert oru.MAX_ORU == jo.MAX_ORU
    for obb in (False, True):
        cfg = dict(capacity=16, is_obb=obb, delta_t=4)
        want = _jax_to_numpy([jo.init_state(jo.OcSortConfig(**cfg))] * 2)
        got = to.state_to_numpy(to.init_state(to.OcSortConfig(**cfg), 2, "cpu"))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        back = to.state_to_numpy(to.state_from_numpy(want, "cpu"))
        assert all(np.array_equal(back[k], want[k]) for k in want)
    assert get_tracker_defaults("ocsort") == jax_defaults("ocsort")
    for params in ({}, {"inertia": 0.3, "use_byte": True, "Q_xy_scaling": 0.5, "max_age": 12}):
        assert dataclasses.asdict(build_replay_config("ocsort", **params)) == \
            dataclasses.asdict(jax_build_replay_config("ocsort", **params))


@pytest.mark.parametrize("kw", [{}, dict(det_thresh=0.4, max_age=12, min_hits=2, iou_threshold=0.2,
                                         delta_t=2, inertia=0.3, use_byte=True, Q_xy_scaling=0.1,
                                         Q_s_scaling=0.01, asso_func="giou")])
def test_live_config_resolution_equals_jax(kw):
    jt, tt = boxmot_tpu.create_tracker("ocsort", **kw), create_tracker("ocsort", device="cpu", **kw)
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    assert (tt.det_thresh, tt.max_age, tt.min_hits, tt.iou_threshold, tt.asso_func_name) == (
        jt.det_thresh, jt.max_age, jt.min_hits, jt.iou_threshold, jt.asso_func_name)


@pytest.mark.parametrize("per_class", [False, True])
def test_live_update_equals_jax(per_class):
    frames = _public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 30)
    rng = np.random.default_rng(0)
    img = np.zeros((1080, 1920, 3), np.uint8)
    kw = dict(LIVE_KW, per_class=per_class)
    jt, tt = boxmot_tpu.create_tracker("ocsort", **kw), create_tracker("ocsort", device="cpu", **kw)
    if per_class:
        jt.nr_classes = tt.nr_classes = 3  # keep the per-class loop short
    rows = 0
    for f, dets in enumerate(frames):
        if per_class:
            dets = dets.copy()
            dets[:, 5] = rng.integers(0, 2, len(dets))
        if f % 7 == 3:
            dets = dets[len(dets) // 3:]  # some tracks miss a frame: OCR and the ORU run
        want = np.asarray(jt.update(dets, img))
        got = np.asarray(tt.update(dets, img))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
        rows += len(got)
    assert rows > 150
    assert tt.update(None, img).shape == (0, 8)


def test_live_obb_update_equals_jax():
    img = np.zeros((1080, 1920, 3), np.uint8)
    rows = 0
    # 33-60 boxes a frame: one detection bucket, so one JAX compile
    for frames in (mmot_obb_dets(MMOT)["data24-1"], synthetic_obb_frames(12, 50, seed=9, miss=0.1)):
        jt = boxmot_tpu.create_tracker("ocsort", **LIVE_KW)
        tt = create_tracker("ocsort", device="cpu", **LIVE_KW)
        for f, dets in enumerate(frames):
            want = np.asarray(jt.update(dets, img))
            got = np.asarray(tt.update(dets, img))
            assert got.shape == want.shape and got.shape[1] == 9, f
            np.testing.assert_array_equal(got[:, 5:], want[:, 5:], err_msg=f"frame {f}")
            np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=RTOL, atol=1e-3)
            rows += len(got)
        assert tt.is_obb and tt.cfg.is_obb
    assert rows > 200


def test_centroid_association_takes_the_first_frame_size():
    """``asso_func="centroid"`` needs the frame size, which the live shell
    takes from the first image (the JAX shell's first-frame hook)."""
    trk = create_tracker("ocsort", device="cpu", asso_func="centroid", min_hits=1, det_thresh=0.5)
    img = np.zeros((480, 640, 3), np.uint8)
    for f in range(5):
        dets = np.array([[50 + 4 * f, 60, 110 + 4 * f, 180, 0.9, 0]], F32)
        out = np.asarray(trk.update(dets, img))
    assert (trk.cfg.frame_w, trk.cfg.frame_h) == (640.0, 480.0)
    assert len(out) == 1 and out[0, 4] == 1  # one track held by centroid distance


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_ocsort_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "ocsort", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "ocsort")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]


def test_run_eval_obb_ocsort_reproduces_jax():
    res = run_eval_obb(MMOT, "ocsort", device="cpu")
    for k, v in JAX_OBB_EVAL["ocsort"].items():
        assert abs(float(res["combined"][k]) - v) <= ATOL, (k, res["combined"])
    assert math.isfinite(float(res["combined"]["HOTA"]))


def test_live_update_with_nan_detections_equals_jax():
    """NaN coordinates in some detections (``with_nan_detections``): NaN
    costs reach the auction and NaN-born tracks the Kalman bank; the rows
    equal JAX's."""
    from chip_smoke import NAN_FRAMES, with_nan_detections

    frames = with_nan_detections(_public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 14))
    img = np.zeros((1080, 1920, 3), np.uint8)
    jt, tt = boxmot_tpu.create_tracker("ocsort"), create_tracker("ocsort", device="cpu")
    rows, nan_state = 0, False
    for f, dets in enumerate(frames):
        want = np.asarray(jt.update(dets, img))
        got = np.asarray(tt.update(dets, img))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
        nan_state |= bool(torch.isnan(tt._state.mean).any())
        rows += len(got)
    assert rows > 100 and nan_state and all(np.isnan(frames[f][1, 0]) for f in NAN_FRAMES)

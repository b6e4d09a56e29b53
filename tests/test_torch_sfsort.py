"""The port's SFSORT (AABB and OBB) against the JAX package and its pins.

The batched step runs S = 2 sequences from JAX states carried across with
``state_from_numpy``; every frame, ids, status, masks and ``det_ind`` must
equal the JAX step's exactly.  Boxes are copies of detections, so AABB
boxes are exact too; OBB boxes go through the angle alignment and smoothing
and are held at rtol 1e-4 (``log``/``cos``/``sin`` differ by an ulp between
XLA and PyTorch).  ``run_eval`` must reproduce the two ``sfsort`` pins and
``run_eval_obb`` the JAX package's mmot-mini values.
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
from boxmot_tpu.ops.rotated_iou import iou_batch_obb
from boxmot_tpu.trackers import sfsort as jsf
from boxmot_tpu_torch import create_tracker, run_eval, run_eval_obb
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import pack_frames
from boxmot_tpu_torch.trackers import sfsort as tsf
from chip_smoke import synthetic_obb_frames
from tests.test_pinned_metrics import PINNED, ROOTS, assert_pinned
from tests.test_torch_bytetrack import _public_frames
from tests.test_torch_obb import ATOL, JAX_OBB_EVAL, MMOT

ASSETS = Path(__file__).resolve().parent.parent / "assets"
RTOL = 1e-4
EXACT = ("status", "tid", "det_ind", "cls", "conf", "last_frame", "frame_count", "next_id",
         "margins")
# the live trackers' resolution with these timeouts, at capacity 64, so the
# step test and the live test share one JAX compile
LIVE_KW = dict(marginal_timeout=3, central_timeout=5, capacity=64)
MARGINS = np.array([[100.0, 1820.0, 80.0, 1000.0], [0.0, 1e9, 0.0, 1e9]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _jax_to_numpy(states):
    return {f.name: np.stack([np.asarray(getattr(s, f.name)) for s in states])
            for f in dataclasses.fields(jsf.SFSortState)}


def _run_steps(jcfg, tcfg, packed, carry_at, box_atol):
    S, n_frames = packed.shape[0], packed.shape[1]
    conf_i = 5 if jcfg.is_obb else 4
    jstates = [jsf.init_state(jcfg, margins=MARGINS[s]) for s in range(S)]
    tstate, rows = None, 0
    for f in range(n_frames):
        if f == carry_at:
            tstate = tsf.state_from_numpy(_jax_to_numpy(jstates), "cpu")
        outs, masks = [], []
        for s in range(S):
            dets = jnp.asarray(packed[s, f])
            jstates[s], out, mask = jsf.sfsort_step(jcfg, jstates[s], dets, dets[:, conf_i] >= 0)
            outs.append(np.asarray(out))
            masks.append(np.asarray(mask))
        if tstate is None:
            continue
        dets = torch.from_numpy(packed[:, f])
        tstate, tout, tmask = tsf.sfsort_step(tcfg, tstate, dets, dets[..., conf_i] >= 0)
        got, want = tsf.state_to_numpy(tstate), _jax_to_numpy(jstates)
        for name in EXACT:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        live = want["status"] != tsf.EMPTY
        np.testing.assert_allclose(got["bbox"][live], want["bbox"][live], rtol=RTOL, atol=box_atol)
        np.testing.assert_allclose(got["theta_vel"], want["theta_vel"], rtol=RTOL, atol=1e-5)
        np.testing.assert_array_equal(tmask.numpy(), np.stack(masks), err_msg=f"mask at {f}")
        tout, jout = tout.numpy(), np.stack(outs)
        B = 5 if jcfg.is_obb else 4
        np.testing.assert_array_equal(tout[..., B:], jout[..., B:], err_msg=f"out at {f}")
        np.testing.assert_allclose(tout[..., :B], jout[..., :B], rtol=RTOL, atol=box_atol)
        rows += int(tmask.sum())
    assert int(tstate.lap_capped.sum()) == 0
    return tstate, rows


@pytest.mark.parametrize("dynamic, carry_at", [(False, 0), (False, 7), (True, 0)])
def test_aabb_step_frame_by_frame_equals_jax(dynamic, carry_at):
    n_frames, D = 40, 32
    seqs = [_public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", n_frames),
            _public_frames(ASSETS / "synth-long/train/SYNTH-01", n_frames)]
    packed = np.stack([pack_frames(s, D=D, F=n_frames)[0] for s in seqs])
    kw = dict(LIVE_KW)
    if dynamic:
        kw.update(dynamic_tuning=True, high_th_m=0.05, new_track_th_m=0.04, match_th_first_m=0.03)
    jcfg, tcfg = jsf.SFSortConfig(**kw), tsf.SFSortConfig(**kw)
    state, rows = _run_steps(jcfg, tcfg, packed, carry_at, box_atol=0.0)
    assert rows > 600
    lost = state.status[0]
    assert ((lost == tsf.LOST_CENTRAL) | (lost == tsf.LOST_MARGINAL)).any() or dynamic


@pytest.mark.parametrize("carry_at", [0, 8])
def test_obb_step_frame_by_frame_equals_jax(carry_at):
    n_frames, D = 24, 64
    seqs = [synthetic_obb_frames(n_frames, 50, seed=1), synthetic_obb_frames(n_frames, 40, seed=2)]
    packed = np.stack([pack_frames(s, D=D, F=n_frames, det_cols=7)[0] for s in seqs])
    kw = dict(LIVE_KW, is_obb=True)
    _, rows = _run_steps(jsf.SFSortConfig(**kw), tsf.SFSortConfig(**kw), packed, carry_at,
                         box_atol=1e-3)
    assert rows > 800


def test_costs_equal_jax():
    rng = np.random.default_rng(0)
    trk = np.zeros((40, 4), np.float32)
    trk[:, :2] = rng.uniform(0, 800, (40, 2))
    trk[:, 2:] = trk[:, :2] + rng.uniform(1, 200, (40, 2))
    det = np.concatenate([trk[:25] + rng.normal(0, 5, (25, 4)).astype(np.float32),
                          trk[25:35]], 0)
    det[-1] = [0, 0, 1, 1]
    t, d = torch.from_numpy(trk)[None], torch.from_numpy(det)[None]
    np.testing.assert_array_equal(tsf.bbsi_cost(t, d)[0].numpy(), np.asarray(jsf.bbsi_cost(trk, det)))
    np.testing.assert_array_equal(tsf.iou_cost(t, d)[0].numpy(), np.asarray(jsf.iou_cost(trk, det)))

    otrk = np.concatenate([(trk[:, :2] + trk[:, 2:]) / 2, trk[:, 2:] - trk[:, :2],
                           rng.uniform(-3, 3, (40, 1))], 1).astype(np.float32)
    odet = otrk[:30] + rng.normal(0, 2, (30, 5)).astype(np.float32)
    # jitted, as the JAX step runs them (op by op they compile for ~15 s)
    iou = torch.from_numpy(np.array(jax.jit(iou_batch_obb)(otrk, odet)))[None]
    got = tsf.bbsi_cost_obb(torch.from_numpy(otrk)[None], torch.from_numpy(odet)[None], iou)[0]
    # the hulls come from corners: cos/sin differ by an ulp between XLA and PyTorch
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jsf.bbsi_cost_obb)(otrk, odet)),
                               rtol=0, atol=1e-6)


def test_config_and_state_mirror_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(tsf.SFSortConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(jsf.SFSortConfig)]
    assert tsf.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(jsf.SFSortState))
    for obb in (False, True):
        cfg = dict(capacity=16, is_obb=obb)
        want = _jax_to_numpy([jsf.init_state(jsf.SFSortConfig(**cfg), margins=m) for m in MARGINS])
        got = tsf.state_to_numpy(tsf.init_state(tsf.SFSortConfig(**cfg), 2, "cpu", MARGINS))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
    assert get_tracker_defaults("sfsort") == jax_defaults("sfsort")
    for params in ({}, {"high_th": 0.5, "central_timeout": 9, "horizontal_margin": 40}):
        assert dataclasses.asdict(build_replay_config("sfsort", **params)) == \
            dataclasses.asdict(jax_build_replay_config("sfsort", **params))


@pytest.mark.parametrize("kw", [{}, dict(dynamic_tuning=True, high_th=1.4, high_th_m=0.5,
                                         new_track_th=0.2, low_th=0.9, cth=0.0,
                                         marginal_timeout=900, obb_theta_damping=-1)])
def test_live_config_resolution_equals_jax(kw):
    jt, tt = boxmot_tpu.create_tracker("sfsort", **kw), create_tracker("sfsort", device="cpu", **kw)
    assert dataclasses.asdict(tt.cfg) == dataclasses.asdict(jt.cfg)
    img = np.zeros((720, 1280, 3), np.uint8)
    for t in (jt, tt):
        t.update(np.zeros((0, 6), np.float32), img)
    np.testing.assert_array_equal(tt._margins(), jt._margins())


@pytest.mark.parametrize("per_class", [False, True])
def test_live_update_equals_jax(per_class):
    frames = _public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 30)
    rng = np.random.default_rng(0)
    img = np.zeros((1080, 1920, 3), np.uint8)
    kw = dict(LIVE_KW, per_class=per_class, horizontal_margin=150, vertical_margin=100)
    jt, tt = boxmot_tpu.create_tracker("sfsort", **kw), create_tracker("sfsort", device="cpu", **kw)
    if per_class:
        jt.nr_classes = tt.nr_classes = 3  # keep the per-class loop short
    rows = 0
    for f, dets in enumerate(frames):
        if per_class:
            dets = dets.copy()
            dets[:, 5] = rng.integers(0, 2, len(dets))
        want = np.asarray(jt.update(dets, img))
        got = np.asarray(tt.update(dets, img))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f"frame {f}")
        rows += len(got)
    assert rows > 300
    assert tt.update(None, img).shape == (0, 8)


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_run_eval_reproduces_sfsort_pins(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "sfsort", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "sfsort")])


def test_run_eval_obb_sfsort_reproduces_jax():
    res = run_eval_obb(MMOT, "sfsort", device="cpu")
    for k, v in JAX_OBB_EVAL["sfsort"].items():
        assert abs(float(res["combined"][k]) - v) <= ATOL, (k, res["combined"])
    assert sorted(res["per_class"]) and res["per_seq"] == {}

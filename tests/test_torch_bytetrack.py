"""The port's batched ByteTrack step and live tracker against the JAX package.

The step runs S = 2 sequences at once (a prefix of MOT17-04-FRCNN's public
detections and of synth-long), starting from JAX states carried across
with ``state_from_numpy``; every frame, ids, status, masks and ``det_ind``
must equal the JAX step's exactly, and means and covariances must agree at
rtol 1e-4, with an absolute floor of 1e-4 times each slot's largest entry
(the Kalman update sums its products in another order than XLA).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxmot_tpu
from boxmot_tpu.data.mot import MOTDataset
from boxmot_tpu.trackers import bytetrack as jbt
from boxmot_tpu_torch import create_tracker
from boxmot_tpu_torch.engine.replay import pack_frames
from boxmot_tpu_torch.trackers import bytetrack as tbt

ASSETS = Path(__file__).resolve().parent.parent / "assets"
RTOL = 1e-4
EXACT = ("status", "activated", "tid", "det_ind", "cls", "frame_id", "start_frame",
         "tracklet_len", "frame_count", "next_id")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _public_frames(seq_dir, n):
    """The first n frames of a sequence's det.txt as (Ni, 6) arrays."""
    seq = MOTDataset(seq_dir.parent, names=[seq_dir.name]).sequences[0]
    rows = seq.public_dets()
    out = []
    for f in range(1, n + 1):
        sel = rows[rows[:, 0] == f]
        out.append(np.stack([sel[:, 2], sel[:, 3], sel[:, 2] + sel[:, 4], sel[:, 3] + sel[:, 5],
                             sel[:, 6], np.zeros(len(sel))], axis=1).astype(np.float32))
    return out


def _jax_to_numpy(states):
    return {f.name: np.stack([np.asarray(getattr(s, f.name)) for s in states])
            for f in dataclasses.fields(jbt.ByteTrackState)}


def _assert_states_match(got, want, frame):
    for name in EXACT:
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {frame}")
    live = want["status"] > 0
    for name in ("mean", "cov"):
        g, w = got[name][live], want[name][live]
        scale = np.abs(w).reshape(len(w), -1).max(axis=1).reshape((-1,) + (1,) * (w.ndim - 1))
        np.testing.assert_array_less(np.abs(g - w), RTOL * np.abs(w) + RTOL * scale + 1e-12,
                                     err_msg=f"{name} at frame {frame}")


@pytest.mark.parametrize("carry_at", [0, 12])
def test_step_frame_by_frame_equals_jax(carry_at):
    n_frames = 60
    seqs = [_public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", n_frames),
            _public_frames(ASSETS / "synth-long/train/SYNTH-01", n_frames)]
    D = 64
    packed = np.stack([pack_frames(s, D=D, F=n_frames)[0] for s in seqs])  # (2, F, D, 7)
    cfg_kw = dict(track_thresh=0.6, match_thresh=0.9, capacity=128)
    jcfg, tcfg = jbt.ByteTrackConfig(**cfg_kw), tbt.ByteTrackConfig(**cfg_kw)

    jstates = [jbt.init_state(jcfg) for _ in seqs]
    tstate = None
    rows = 0
    for f in range(n_frames):
        if f == carry_at:
            tstate = tbt.state_from_numpy(_jax_to_numpy(jstates), "cpu")
        outs, masks = [], []
        for s in range(len(seqs)):
            dets = jnp.asarray(packed[s, f])
            jstates[s], out, mask = jbt.bytetrack_step(jcfg, jstates[s], dets, dets[:, 4] >= 0)
            outs.append(np.asarray(out))
            masks.append(np.asarray(mask))
        if tstate is None:
            continue
        dets = torch.from_numpy(packed[:, f])
        tstate, tout, tmask = tbt.bytetrack_step(tcfg, tstate, dets, dets[..., 4] >= 0)
        want = _jax_to_numpy(jstates)
        _assert_states_match(tbt.state_to_numpy(tstate), want, f)
        np.testing.assert_array_equal(tmask.numpy(), np.stack(masks), err_msg=f"mask at {f}")
        tout, jout = tout.numpy(), np.stack(outs)
        np.testing.assert_array_equal(tout[..., 4:], jout[..., 4:], err_msg=f"out at {f}")
        np.testing.assert_allclose(tout[..., :4], jout[..., :4], rtol=RTOL, atol=1e-2)
        rows += int(tmask.sum())
    assert rows > 500  # the prefix really tracks


def test_state_round_trip():
    jcfg = jbt.ByteTrackConfig(capacity=16)
    st = jbt.init_state(jcfg)
    dets = np.zeros((8, 7), np.float32)
    dets[:, 2:4] = 1
    dets[:, 4] = -1
    dets[:3] = [[10, 10, 50, 90, 0.9, 0, 0], [100, 20, 140, 120, 0.8, 0, 1],
                [300, 40, 330, 99, 0.3, 0, 2]]
    st, _, _ = jbt.bytetrack_step(jcfg, st, jnp.asarray(dets), jnp.asarray(dets[:, 4] >= 0))
    arrays = _jax_to_numpy([st, st])
    back = tbt.state_to_numpy(tbt.state_from_numpy(arrays, "cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
        assert back[k].dtype == arrays[k].dtype, k


def test_config_mirrors_jax_field_for_field():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(tbt.ByteTrackConfig)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(jbt.ByteTrackConfig)
    ]
    assert tbt.JAX_FIELDS == tuple(f.name for f in dataclasses.fields(jbt.ByteTrackState))


def test_live_config_resolution_equals_jax():
    jcfg = boxmot_tpu.create_tracker("bytetrack").cfg
    tcfg = create_tracker("bytetrack", device="cpu").cfg
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.det_thresh == 0.6 and tcfg.max_time_lost == 30  # track_thresh, buffer
    kw = dict(track_buffer=50, frame_rate=25, track_thresh=0.5)
    assert dataclasses.asdict(create_tracker("bytetrack", device="cpu", **kw).cfg) == \
        dataclasses.asdict(boxmot_tpu.create_tracker("bytetrack", **kw).cfg)


@pytest.mark.parametrize("per_class", [False, True])
def test_live_update_equals_jax(per_class):
    frames = _public_frames(ASSETS / "MOT17-mini/train/MOT17-04-FRCNN", 25)
    rng = np.random.default_rng(0)
    img = np.zeros((1080, 1920, 3), np.uint8)
    jt = boxmot_tpu.create_tracker("bytetrack", per_class=per_class)
    tt = create_tracker("bytetrack", device="cpu", per_class=per_class)
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
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:], err_msg=f"frame {f}")
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=RTOL, atol=1e-3)
        rows += len(got)
    assert rows > 200
    assert tt.update(None, img).shape == (0, 8)


def test_unported_paths_raise():
    with pytest.raises(ValueError, match="Slice 3"):
        create_tracker("ocsort", device="cpu")
    with pytest.raises(ValueError, match="Slice 4"):
        create_tracker("occluboost", device="cpu")
    with pytest.raises(ValueError, match="Unknown tracker"):
        create_tracker("nosuch", device="cpu")
    with pytest.raises(NotImplementedError, match="Slice 2"):
        create_tracker("bytetrack", device="cpu").update(np.zeros((1, 7), np.float32))
    with pytest.raises(NotImplementedError, match="Slice 2"):
        tbt.init_state(tbt.ByteTrackConfig(is_obb=True), 1, "cpu")
    with pytest.raises(AssertionError):
        create_tracker("bytetrack", device="cpu").update(np.zeros((1, 5), np.float32))

"""The check that decides ``correct`` comes out false when the timed path is
broken underneath a run (on the CPU, at a small size, the look for a card
skipped): a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced, and for the replay cell its
appearance products made in TF32 (the control's precision, emulated by
rounding their inputs).  (One card: no exchange between chips to leave
out.)  Unbroken, the same run is correct."""

import pytest
import torch

from portbench.tests.conftest import LIVE, REPLAY, drive

SEED = 2**31 + 77


def _state_unchanged(step):
    def broken(cfg, state, *args):
        _, out, mask = step(cfg, state, *args)
        return state, out, mask
    return broken


def live_state_unchanged(run):
    run.fused._step = _state_unchanged(run.fused._step)


def live_half_left_out(run):
    det = run.fused.detector
    real = det.detect

    def detect(img, max_dets=None):
        boxes, score, cls_id, keep_idx, keep_mask = real(img, max_dets)
        keep_mask = keep_mask.clone()
        keep_mask[keep_mask.shape[0] // 2:] = False
        return boxes, score, cls_id, keep_idx, keep_mask

    det.detect = detect


def live_answer_altered(run):
    real = run.fused.update_async

    def update_async(frame):
        out, mask = real(frame)
        if run.fused.frame_count == 3:
            out = out.clone()
            out[:, 4] += 1.0
        return out, mask

    run.fused.update_async = update_async


@pytest.fixture
def replay_module(monkeypatch):
    from boxmot_tpu_torch.engine import replay
    from boxmot_tpu_torch.trackers import hybridsort
    return monkeypatch, replay, hybridsort


def test_live_unbroken_is_correct():
    correct, numbers, _ = drive(LIVE, SEED)
    assert correct, numbers


@pytest.mark.parametrize("fault", [live_state_unchanged, live_half_left_out, live_answer_altered])
def test_live_fault_is_not_correct(fault):
    correct, numbers, _ = drive(LIVE, SEED, fault=fault)
    assert not correct, numbers


def test_replay_unbroken_is_correct():
    correct, numbers, _ = drive(REPLAY, SEED)
    assert correct, numbers


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 bits of mantissa (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered",
                                   "products_in_tf32"])
def test_replay_fault_is_not_correct(replay_module, fault):
    monkeypatch, replay, hybridsort = replay_module
    if fault == "state_unchanged":
        monkeypatch.setattr(hybridsort, "hybridsort_step",
                            _state_unchanged(hybridsort.hybridsort_step))
    elif fault == "products_in_tf32":
        real = hybridsort._emb_dist
        monkeypatch.setattr(hybridsort, "_emb_dist", lambda smooth, feat: real(_tf32(smooth),
                                                                             _tf32(feat)))
    else:
        real = replay.batch_replay

        def batch_replay(*args, **kwargs):
            states, outs, masks = real(*args, **kwargs)
            if fault == "half_left_out":
                masks[masks.shape[0] // 2:] = False
            else:
                s, f, k = (int(i[0]) for i in torch.nonzero(masks, as_tuple=True))
                outs[s, f, k, 4] += 1.0
            return states, outs, masks

        monkeypatch.setattr(replay, "batch_replay", batch_replay)
    correct, numbers, _ = drive(REPLAY, SEED)
    assert not correct, numbers

"""Sequence replay over cached detections, on the device (counterpart of
boxmot_tpu/engine/replay.py).

The JAX package runs one sequence as ``lax.scan`` over the jitted step
and batches sequences with ``vmap``.  Here the tracker state carries the
batch axis S and ``batch_replay`` is a Python loop over frames that calls
the batched step of the config's tracker (``resolve_tracker``) once per
frame.  Every output stays on the device until the batch has finished;
``_to_host`` then makes the one device-to-host copy.  Frame and detection counts are padded to the same static buckets
as in the JAX package; padded outputs are cut off on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from boxmot_tpu_torch.engine.mot_io import convert_to_mot_format
from boxmot_tpu_torch.trackers import bytetrack, sfsort
from boxmot_tpu_torch.utils.device import resolve_device

FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)
DET_BUCKETS = (8, 16, 32, 64, 128, 256)


def resolve_tracker(cfg):
    """(init_state, step) of the tracker a config belongs to.

    ``init_state(cfg, n, device)`` gives n fresh states stacked on the batch
    axis; ``step(cfg, states, dets, det_valid)`` advances them one frame.
    """
    if isinstance(cfg, bytetrack.ByteTrackConfig):
        return bytetrack.init_state, bytetrack.bytetrack_step
    if isinstance(cfg, sfsort.SFSortConfig):
        return sfsort.init_state, sfsort.sfsort_step
    raise TypeError(f"unknown tracker config type {type(cfg).__name__}")


def _det_cols(cfg) -> int:
    """Detection columns: 7 for oriented [cx, cy, w, h, theta, conf, cls],
    6 for axis-aligned [x1, y1, x2, y2, conf, cls]."""
    return 7 if cfg.is_obb else 6


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def pack_frames(dets_per_frame, D=None, F=None, det_cols: int = 6):
    """Pack a list of (Ni, det_cols) det arrays into (F, D, det_cols + 1)
    with det indices appended.  Padding rows have conf = -1 and unit boxes."""
    conf_idx = det_cols - 2
    n_frames = len(dets_per_frame)
    max_d = max((len(d) for d in dets_per_frame), default=1)
    D = D or _bucket(max(max_d, 1), DET_BUCKETS)
    F = F or _bucket(max(n_frames, 1), FRAME_BUCKETS)
    out = np.zeros((F, D, det_cols + 1), np.float32)
    out[:, :, 2:4] = 1.0
    out[:, :, conf_idx] = -1.0
    for f, d in enumerate(dets_per_frame):
        n = len(d)
        if n:
            out[f, :n, :det_cols] = d[:, :det_cols]
            out[f, :n, det_cols] = np.arange(n)
    return out, n_frames


def _unpack_mot_rows(outs, masks, n_frames, frame_offset: int = 0):
    """Gather replay outputs of one sequence into MOT rows (host numpy)."""
    rows = []
    for f in range(n_frames):
        frame_rows = outs[f][masks[f]]
        if len(frame_rows):
            rows.append(convert_to_mot_format(frame_rows, frame_offset + f + 1))
    if rows:
        return np.concatenate(rows, axis=0)
    return np.empty((0, 9), np.float32)


def init_states(cfg, n: int, device):
    """n fresh tracker states stacked along the batch axis."""
    return resolve_tracker(cfg)[0](cfg, n, resolve_device(device))


def batch_replay(cfg, states, dets_batch: torch.Tensor, n_frames: int | None = None):
    """Replay S sequences in lockstep: dets_batch (S, F, D, det_cols + 1) on
    the states' device.  Runs the first ``n_frames`` frames (all by default;
    later frames cannot change earlier outputs).

    Returns (states, outs (S, n_frames, K, 8 or 9), masks (S, n_frames, K)),
    all on the device; nothing here waits for the device.
    """
    step = resolve_tracker(cfg)[1]
    S, F = dets_batch.shape[0], dets_batch.shape[1]
    n_frames = F if n_frames is None else n_frames
    dev = dets_batch.device
    out_cols = _det_cols(cfg) + 2  # box, id, conf, cls, det_ind
    outs = torch.empty((S, n_frames, cfg.capacity, out_cols), dtype=torch.float32, device=dev)
    masks = torch.empty((S, n_frames, cfg.capacity), dtype=torch.bool, device=dev)
    det_valid = dets_batch[..., _det_cols(cfg) - 2] >= 0.0  # the conf column
    for f in range(n_frames):
        states, outs[:, f], masks[:, f] = step(cfg, states, dets_batch[:, f], det_valid[:, f])
    return states, outs, masks


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host-to-device copy that does not block the host (pinned source)."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _to_host(*tensors: torch.Tensor):
    """The one device-to-host copy of a replay batch.

    A caller may run the replay under ``torch.cuda.set_sync_debug_mode("error")``
    to prove that the frame loop never waits for the device; this copy is
    the one place that must, so the mode is lifted for it alone.
    """
    if not tensors[0].is_cuda:
        return [t.numpy() for t in tensors]
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return [t.cpu().numpy() for t in tensors]
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def replay_sequences_outputs(cfg, seqs, *, device="cuda"):
    """Replay many sequences; return (outs (n_frames, K, 8 or 9), masks
    (n_frames, K)) on the host for each, in input order.

    ``seqs`` is a list of dicts with key ``dets`` (list of per-frame (Ni, 6)
    or, for an OBB config, (Ni, 7) arrays).  Sequences that share a (frame,
    det) bucket run as one batch.  Raises if any assignment stopped at the
    auction's iteration cap, since its matches would then be a truncated
    solve.
    """
    device = resolve_device(device)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, s in enumerate(seqs):
        dets = s["dets"]
        max_d = max((len(d) for d in dets), default=1)
        key = (_bucket(max(len(dets), 1), FRAME_BUCKETS), _bucket(max(max_d, 1), DET_BUCKETS))
        groups.setdefault(key, []).append(i)

    results: list = [None] * len(seqs)
    for (F, D), idxs in groups.items():
        packed, n_frames_list = [], []
        for i in idxs:
            p, n_frames = pack_frames(seqs[i]["dets"], D=D, F=F, det_cols=_det_cols(cfg))
            packed.append(p)
            n_frames_list.append(n_frames)
        dets_batch = _to_device(np.stack(packed), device)
        states = init_states(cfg, len(idxs), device)
        states, outs, masks = batch_replay(cfg, states, dets_batch, max(n_frames_list))
        outs, masks, capped = _to_host(outs, masks, states.lap_capped)
        if capped.any():
            raise RuntimeError(
                f"{int(capped.sum())} assignment(s) stopped at the auction's "
                "iteration cap; their matches are not a finished solve"
            )
        for k, i in enumerate(idxs):
            results[i] = (outs[k, :n_frames_list[k]], masks[k, :n_frames_list[k]])
    return results


def replay_sequences_batched(cfg, seqs, *, device="cuda"):
    """Replay many axis-aligned sequences; return one MOT row array each,
    in input order (see ``replay_sequences_outputs``)."""
    return [_unpack_mot_rows(outs, masks, len(outs))
            for outs, masks in replay_sequences_outputs(cfg, seqs, device=device)]


def replay_sequence(cfg, dets_per_frame, *, device="cuda"):
    """Replay one sequence and return MOT rows (N, 9) on the host."""
    return replay_sequences_batched(cfg, [{"dets": dets_per_frame}], device=device)[0]

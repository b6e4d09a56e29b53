"""Sequence replay over cached detections, on the device (counterpart of
boxmot_tpu/engine/replay.py).

The JAX package runs one sequence as ``lax.scan`` over the jitted step
and batches sequences with ``vmap``.  Here the tracker state carries the
batch axis S and ``batch_replay`` is a Python loop over frames that calls
the batched step of the config's tracker (``resolve_tracker``) once per
frame, with the frame's appearance embeddings and camera-motion warps for
the trackers that take them (zeros and the identity by default, as the
JAX replay's ``_default_embs`` and ``_default_warps``).  Every output stays
on the device until the batch has finished; ``_to_host`` then makes the one
device-to-host copy.  Frame and detection counts are padded to the same
static buckets as in the JAX package; padded outputs are cut off on the
host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.engine.mot_io import convert_to_mot_format
from boxmot_tpu_torch.trackers import (
    boosttrack,
    botsort,
    bytetrack,
    deepocsort,
    hybridsort,
    occluboost,
    ocsort,
    sfsort,
    strongsort,
)
from boxmot_tpu_torch.utils.device import resolve_device

FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)
DET_BUCKETS = (8, 16, 32, 64, 128, 256)


def _motion_only(step):
    return lambda cfg, states, dets, det_valid, embs, warps: step(cfg, states, dets, det_valid)


def resolve_tracker(cfg):
    """(init_state, step) of the tracker a config belongs to.

    ``init_state(cfg, n, device)`` gives n fresh states stacked on the batch
    axis; ``step(cfg, states, dets, det_valid, embs, warps)`` advances them
    one frame (motion-only trackers ignore the embeddings and warps, as in
    the JAX package).
    """
    if isinstance(cfg, bytetrack.ByteTrackConfig):
        return bytetrack.init_state, _motion_only(bytetrack.bytetrack_step)
    if isinstance(cfg, sfsort.SFSortConfig):
        return sfsort.init_state, _motion_only(sfsort.sfsort_step)
    if isinstance(cfg, ocsort.OcSortConfig):
        return ocsort.init_state, _motion_only(ocsort.ocsort_step)
    if isinstance(cfg, botsort.BotSortConfig):
        return botsort.init_state, botsort.botsort_step
    if isinstance(cfg, deepocsort.DeepOcSortConfig):
        return deepocsort.init_state, deepocsort.deepocsort_step
    if isinstance(cfg, boosttrack.BoostTrackConfig):
        return boosttrack.init_state, boosttrack.boosttrack_step
    if isinstance(cfg, occluboost.OccluBoostConfig):
        return occluboost.init_state, occluboost.occluboost_step
    if isinstance(cfg, strongsort.StrongSortConfig):
        return strongsort.init_state, strongsort.strongsort_step
    if isinstance(cfg, hybridsort.HybridSortConfig):
        return hybridsort.init_state, hybridsort.hybridsort_step
    raise TypeError(f"unknown tracker config type {type(cfg).__name__}")


def wants_embs(cfg) -> bool:
    """Whether the config's step reads appearance embeddings: DeepOCSORT,
    StrongSORT and HybridSORT always (zeros when none are given; HybridSORT
    writes them to a newborn track's features even without ReID), BoT-SORT,
    BoostTrack and OccluBoost with ``with_reid``."""
    if isinstance(cfg, (botsort.BotSortConfig, boosttrack.BoostTrackConfig,
                        occluboost.OccluBoostConfig)):
        return cfg.with_reid
    return isinstance(cfg, (deepocsort.DeepOcSortConfig, strongsort.StrongSortConfig,
                            hybridsort.HybridSortConfig))


def wants_warps(cfg) -> bool:
    """Whether the config's step applies camera-motion warps (OccluBoost's
    oriented mode applies none)."""
    if isinstance(cfg, occluboost.OccluBoostConfig):
        return not cfg.is_obb
    return isinstance(cfg, (botsort.BotSortConfig, deepocsort.DeepOcSortConfig,
                            boosttrack.BoostTrackConfig, strongsort.StrongSortConfig,
                            hybridsort.HybridSortConfig))


def _det_cols(cfg) -> int:
    """Detection columns: 7 for oriented [cx, cy, w, h, theta, conf, cls],
    6 for axis-aligned [x1, y1, x2, y2, conf, cls]."""
    return 7 if getattr(cfg, "is_obb", False) else 6


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


def pack_embs(embs_per_frame, feat_dim, D=None, F=None):
    """Pack per-frame (Ni, feat_dim) embeddings into (F, D, feat_dim), rows
    aligned with ``pack_frames``'s detections and zero padding."""
    n_frames = len(embs_per_frame)
    max_d = max((len(e) for e in embs_per_frame), default=1)
    D = D or _bucket(max(max_d, 1), DET_BUCKETS)
    F = F or _bucket(max(n_frames, 1), FRAME_BUCKETS)
    out = np.zeros((F, D, feat_dim), np.float32)
    for f, e in enumerate(embs_per_frame):
        if len(e):
            out[f, : len(e)] = e
    return out


def pack_warps(warps, F):
    """(F, 2, 3) float32 warps: the given (n, 2, 3) ones first, the identity
    after them (and for every frame when ``warps`` is None)."""
    out = np.broadcast_to(np.eye(2, 3, dtype=np.float32), (F, 2, 3)).copy()
    if warps is not None:
        out[: len(warps)] = warps
    return out


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


def batch_replay(cfg, states, dets_batch: torch.Tensor, n_frames: int | None = None,
                 embs: torch.Tensor | None = None, warps: torch.Tensor | None = None):
    """Replay S sequences in lockstep: dets_batch (S, F, D, det_cols + 1) on
    the states' device; for the appearance trackers, optional embs
    (S, F, D, feat_dim) and warps (S, F, 2, 3) on the same device.  Runs the
    first ``n_frames`` frames (all by default; later frames cannot change
    earlier outputs).  Without embs a step that reads them gets zeros (one
    (S, D, feat_dim) buffer for every frame); BoT-SORT with ``with_reid``
    off reads none.  Without warps every frame's warp is the identity.

    Returns (states, outs (S, n_frames, K, 8 or 9), masks (S, n_frames, K)),
    all on the device; nothing here waits for the device.
    """
    step = resolve_tracker(cfg)[1]
    S, F, D = dets_batch.shape[:3]
    n_frames = F if n_frames is None else n_frames
    dev = dets_batch.device
    out_cols = _det_cols(cfg) + 2  # box, id, conf, cls, det_ind
    outs = torch.empty((S, n_frames, cfg.capacity, out_cols), dtype=torch.float32, device=dev)
    masks = torch.empty((S, n_frames, cfg.capacity), dtype=torch.bool, device=dev)
    det_valid = dets_batch[..., _det_cols(cfg) - 2] >= 0.0  # the conf column
    zero_embs = identity = None
    if embs is None and wants_embs(cfg):
        zero_embs = torch.zeros((S, D, cfg.feat_dim), dtype=torch.float32, device=dev)
    if warps is None and wants_warps(cfg):
        identity = torch.eye(2, 3, dtype=torch.float32, device=dev).expand(S, 2, 3)
    for f in range(n_frames):
        states, outs[:, f], masks[:, f] = step(
            cfg, states, dets_batch[:, f], det_valid[:, f],
            zero_embs if embs is None else embs[:, f],
            identity if warps is None else warps[:, f])
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


def _state_row(states, k: int):
    """Sequence k of a batched tracker state, as a state of one sequence."""
    return type(states)(**{f.name: getattr(states, f.name)[k:k + 1]
                           for f in dataclasses.fields(states)})


def replay_sequences_outputs(cfg, seqs, *, device="cuda", with_states: bool = False):
    """Replay many sequences; return (outs (n_frames, K, 8 or 9), masks
    (n_frames, K)) on the host for each, in input order; with
    ``with_states``, (outs, masks, state) with each sequence's final tracker
    state (a batch of one, on ``device``), from which e.g. OccluBoost's
    ``flush_gta_rows`` reads the gap rows.

    ``seqs`` is a list of dicts with key ``dets`` (list of per-frame (Ni, 6)
    or, for an OBB config, (Ni, 7) arrays) and, as in the JAX
    ``replay_sequences_batched``, optional ``embs`` (per-frame (Ni, feat_dim)
    arrays, read by the trackers that use appearance) and ``warps`` ((n, 2, 3)
    camera-motion warps, the identity after them; read by BoT-SORT,
    DeepOCSORT, BoostTrack, axis-aligned OccluBoost, StrongSORT and
    HybridSORT).  Sequences that
    share a (frame, det) bucket run as one batch; where one of them has
    embeddings or warps, the others get zeros or identities.  Raises if any
    assignment stopped at the auction's iteration cap, since its matches
    would then be a truncated solve.
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
        embs = warps = None
        if wants_embs(cfg) and any(seqs[i].get("embs") is not None for i in idxs):
            embs = _to_device(np.stack([
                pack_embs(seqs[i]["embs"], cfg.feat_dim, D=D, F=F)
                if seqs[i].get("embs") is not None
                else np.zeros((F, D, cfg.feat_dim), np.float32) for i in idxs]), device)
        if wants_warps(cfg) and any(seqs[i].get("warps") is not None for i in idxs):
            warps = _to_device(np.stack([pack_warps(seqs[i].get("warps"), F) for i in idxs]),
                               device)
        states = init_states(cfg, len(idxs), device)
        states, outs, masks = batch_replay(cfg, states, dets_batch, max(n_frames_list), embs,
                                           warps)
        outs, masks, capped = _to_host(outs, masks, states.lap_capped)
        if capped.any():
            raise RuntimeError(
                f"{int(capped.sum())} assignment(s) stopped at the auction's "
                "iteration cap; their matches are not a finished solve"
            )
        for k, i in enumerate(idxs):
            results[i] = (outs[k, :n_frames_list[k]], masks[k, :n_frames_list[k]])
            if with_states:
                results[i] += (_state_row(states, k),)
    return results


def replay_sequences_batched(cfg, seqs, *, device="cuda"):
    """Replay many axis-aligned sequences; return one MOT row array each,
    in input order (see ``replay_sequences_outputs``)."""
    return [_unpack_mot_rows(outs, masks, len(outs))
            for outs, masks in replay_sequences_outputs(cfg, seqs, device=device)]


def replay_sequence(cfg, dets_per_frame, embs_per_frame=None, warps=None, *, device="cuda"):
    """Replay one sequence and return MOT rows (N, 9) on the host."""
    seq = {"dets": dets_per_frame, "embs": embs_per_frame, "warps": warps}
    return replay_sequences_batched(cfg, [seq], device=device)[0]

# Frozen copy of boxmot_tpu_torch/trackers/slots.py at commit 78364f93b578: the plain
# (twin) path only, on every device; no kernel, no tracker shell.
"""Slot-bank helpers shared by the batched tracker steps.

Every tensor carries a leading S axis of independent sequences.  Scatters
that the JAX steps write with ``mode="drop"`` write into one spare slot
that is then cut off, so nothing here branches on data or syncs the host.
"""

from __future__ import annotations

import torch


def scatter_det_flags(r2c, matched, D):
    """(S, D) flags of the detection columns taken by matched rows."""
    S = r2c.shape[0]
    idx = torch.where(matched, r2c.long(), D)
    flags = torch.zeros((S, D + 1), dtype=torch.bool, device=r2c.device)
    return flags.scatter(1, idx, True)[:, :D]


def take(x, idx):
    """x (S, D, ...) gathered along D at idx (S, K) -> (S, K, ...)."""
    idx = idx.long()
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def allocate(new_det, free):
    """Give the new detections (S, D) free slots (S, K), both in index order.

    Returns n_new (S,) int32, free_rank (S, K) int32 (a slot's rank among the
    free ones; new ids are next_id + free_rank), takes (S, K) (slots that
    start a track) and slot_det (S, K) (the detection each such slot takes).
    """
    S, D = new_det.shape
    n_new = new_det.sum(dim=1, dtype=torch.int32)
    det_rank = torch.cumsum(new_det, dim=1) - 1
    det_ids = torch.arange(D, device=new_det.device).expand(S, D)
    det_by_rank = torch.full((S, D + 1), D, dtype=torch.int64, device=new_det.device)
    det_by_rank = det_by_rank.scatter(1, torch.where(new_det, det_rank, D), det_ids)[:, :D]
    free_rank = (torch.cumsum(free, dim=1) - 1).to(torch.int32)
    takes = free & (free_rank < n_new[:, None])
    slot_det = torch.clamp(take(det_by_rank, torch.clamp(free_rank, 0, D - 1)), 0, D - 1)
    return n_new, free_rank, takes, slot_det

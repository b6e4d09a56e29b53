"""Sequence-parallel replay over a mesh of devices (counterpart of
``boxmot_tpu/parallel/replay.py``).

The JAX package shards the sequence axis of its lockstep replay over a
``jax.sharding.Mesh``: each chip owns S / n sequences of one SPMD program.
The port's mesh is a tuple of ``torch.device``s, by default every visible
card.  ``sharded_batch_replay`` pads S to a multiple of the mesh's size as
JAX does (empty sequences: detections with conf -1, zero embeddings,
identity warps), runs ``engine/replay.py::batch_replay`` on each entry's
chunk of sequences, on its device, and gathers the states and outputs on
the first device.  On one H100 the mesh has one entry and this is one
``batch_replay`` call, no chunking and no copy beyond the inputs' upload:
the batched replay over S is the whole of it.  ``sharded_reid_features``
is the same over ReID crops.  Every state field has the sequence axis
leading, as in JAX.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.engine.replay import batch_replay, init_states


def sequence_mesh(devices=None) -> tuple:
    """The mesh: ``devices`` as ``torch.device``s, or every visible card;
    without one it raises (it never falls back to the CPU)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("sequence_mesh: no CUDA card is visible; pass devices= to "
                               "build a mesh of other devices")
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("sequence_mesh: a mesh needs at least one device")
    return mesh


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _gather(trees: list, device):
    """Concatenate the tensors of ``trees`` (tuples of states and tensors, one
    structure) along axis 0 on ``device``."""
    first = trees[0]
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _gather([getattr(t, f.name) for t in trees], device)
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        return tuple(_gather(list(vs), device) for vs in zip(*trees))
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in trees])
    return first


def shard_over_sequences(mesh, tree) -> list:
    """Split the leading (sequence) axis of every array of ``tree`` into
    ``len(mesh)`` equal chunks, chunk i on ``mesh[i]``: one tree an entry.
    The leading axis must be a multiple of the mesh's size."""
    n = len(mesh)

    def chunk(i):
        def take(a):
            t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
            if t.shape[0] % n:
                raise ValueError(f"shard_over_sequences: leading axis {t.shape[0]} is not a "
                                 f"multiple of the mesh's {n} devices")
            size = t.shape[0] // n
            return t[i * size:(i + 1) * size].to(mesh[i])
        return take

    return [_map(chunk(i), tree) for i in range(n)]


def _pad(a: np.ndarray, pad: int, fill) -> np.ndarray:
    return np.concatenate([np.asarray(a), np.broadcast_to(fill, (pad,) + a.shape[1:])])


def sharded_batch_replay(cfg, dets_batch, mesh=None, embs_batch=None, warps_batch=None):
    """Replay (S, F, D, det_cols + 1) detection batches, S split over the
    mesh.  S is padded up to a multiple of the mesh's size with empty
    sequences (the JAX package's padding); callers slice the outputs back
    to S.  Returns (states, outs (S_pad, F, K, 8 or 9), masks (S_pad, F,
    K)) on the mesh's first device."""
    mesh = sequence_mesh() if mesh is None else tuple(mesh)
    dets_batch = np.asarray(dets_batch, np.float32)
    S = dets_batch.shape[0]
    pad = (-S) % len(mesh)
    if pad:
        empty = np.zeros((1,) + dets_batch.shape[1:], np.float32)
        empty[..., 2:4] = 1.0
        empty[..., 5 if getattr(cfg, "is_obb", False) else 4] = -1.0
        dets_batch = _pad(dets_batch, pad, empty[0])
        if embs_batch is not None:
            embs_batch = _pad(np.asarray(embs_batch, np.float32), pad, np.float32(0.0))
        if warps_batch is not None:
            warps_batch = _pad(np.asarray(warps_batch, np.float32), pad,
                               np.eye(2, 3, dtype=np.float32))
    inputs = {"dets": dets_batch, "embs": embs_batch, "warps": warps_batch}
    shards = shard_over_sequences(mesh, inputs)
    runs = []
    for dev, shard in zip(mesh, shards):
        states = init_states(cfg, shard["dets"].shape[0], dev)
        runs.append(batch_replay(cfg, states, shard["dets"], embs=shard["embs"],
                                 warps=shard["warps"]))
    if len(runs) == 1:
        return runs[0]
    return _gather(runs, mesh[0])


def _same_device(a: torch.device, b: torch.device) -> bool:
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


@torch.no_grad()
def _embed_on(reid, device, crops: torch.Tensor) -> torch.Tensor:
    """``reid._embed`` of ``crops`` on ``device``: the facade's own model where
    it lives there, else a replica cached on the facade."""
    if _same_device(device, reid.device):
        return reid._embed(crops)
    replicas = reid.__dict__.setdefault("_replicas", {})
    if device not in replicas:
        replicas[device] = copy.deepcopy(reid.model).to(device)
    feats = replicas[device](crops).to(torch.float32)
    norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return feats / torch.clamp_min(norm, 1e-12)


def sharded_reid_features(reid, crops_batch, mesh=None) -> np.ndarray:
    """Data-parallel ReID forward: (N, H, W, 3) standardized crops (the JAX
    package's NHWC layout), N padded to a multiple of the mesh's size and
    split over it, the parameters replicated.  Returns (N, F) L2-normalized
    float32 embeddings on the host."""
    mesh = sequence_mesh() if mesh is None else tuple(mesh)
    crops_batch = np.asarray(crops_batch, np.float32)
    n = crops_batch.shape[0]
    if n == 0:
        return np.zeros((0, reid.feature_dim), np.float32)
    pad = (-n) % len(mesh)
    if pad:
        crops_batch = _pad(crops_batch, pad, np.float32(0.0))
    feats = [_embed_on(reid, dev, shard.permute(0, 3, 1, 2).to(reid.dtype))
             for dev, shard in zip(mesh, shard_over_sequences(mesh, crops_batch))]
    return torch.cat([f.cpu() for f in feats]).numpy()[:n]

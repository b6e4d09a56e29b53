"""The observation-centric re-update (ORU): kernel K4 and its plain twin.

Counterpart of the ORU block of ``boxmot_tpu/trackers/ocsort.py::ocsort_step``
(a ``lax.cond`` around a ``lax.fori_loop``), repeated in ``deepocsort.py``
and, over the XYSCR filter, in ``hybridsort.py``; none has a Pallas kernel.
A track that is matched again after misses ("rejoins") restores the mean and
covariance frozen at its first miss and replays the Kalman filter over
measurements interpolated between its last real measurement and the new
one: for i = 1 .. min(gap, MAX_ORU), a predict (from i = 2 on), then an
update with the i-th interpolated measurement (for oriented boxes the angle
follows the wrapped delta, the measurement is aligned to the replay's own
mean, and the angular velocity is damped x0.8 after the update; for XYSCR
the confidence c is stepped linearly).  Three layouts: XYSR, XYSR-OBB and
XYSCR (``LAYOUT_TAGS``, the kernel's template tags).  The loop's
trip count depends on the data, so in eager PyTorch it would need a host
read; on a CUDA tensor ``oru_replay`` launches ``csrc/oru.cu`` once per step
instead, one warp per slot (``launch_geometry``): a warp whose slot does not
rejoin copies its mean and covariance through, and a rejoining slot's warp
runs the replay over a tile of shared memory, its lanes sharing out the
elements of each stage.  On a CPU tensor it runs ``oru_replay_plain``, the
same masked loop in plain PyTorch with the port's ``kalman.predict`` and
``kalman.update``, whose operations the kernel repeats in the same order.

Both add the number of rejoining slots of each sequence to ``replayed``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.motion import kalman
from boxmot_tpu_torch.ops.geometry import exact, wrap_angle

MAX_ORU = 32  # the longest replay; the reference's gaps are at most max_age
WARPS = 4  # warps a block of K4, one slot each
THREADS = 32 * WARPS
_P = ctypes.c_void_p
_I = ctypes.c_int
# the layouts K4 replays -> (its tag in csrc/oru.cu, dx, dz)
LAYOUT_TAGS = {"xysr": (0, 7, 4), "xysr_obb": (1, 9, 5), "xyscr": (2, 9, 5)}


class Launch(NamedTuple):
    """K4's launch: a grid of ``blocks`` blocks of ``threads`` threads and
    ``shared_bytes`` of dynamic shared memory a block."""

    blocks: int
    threads: int
    shared_bytes: int


def tile_floats(dx: int, dz: int) -> int:
    """Floats of a rejoining slot's tile in K4 (``csrc/oru.cu::Tile``): the
    mean, the measurement, the innovation and the last measurement, 8
    interpolation scalars, 3 x 4 alignment candidates, M = L^-1 and Sinv,
    the gain, I - K H and two covariance buffers."""
    return dx + 3 * dz + 8 + 12 + 2 * dz * dz + dx * dz + 3 * dx * dx


@functools.lru_cache(maxsize=64)
def launch_geometry(S: int, K: int, layout: str) -> Launch:
    """One warp per slot of the S x K, ``WARPS`` to a block, and a tile of
    shared memory a warp, sized by the layout's name (``LAYOUT_TAGS``)."""
    _, dx, dz = LAYOUT_TAGS[layout]
    return Launch(-(-S * K // WARPS), THREADS, 4 * WARPS * tile_floats(dx, dz))


def _aspect(layout) -> int:
    """The measurement column of the aspect r: 4 in XYSCR's [x, y, s, c, r],
    else 3."""
    return 4 if layout.name == "xyscr" else 3


def _interpolation(layout, last_meas, z2, gap):
    """Per slot: the start (w1, h1) and the steps (dx, dy, dw, dh, and the
    oriented layout's wrapped angle or XYSCR's confidence) of the
    interpolated measurements, as the JAX steps form them."""
    r = _aspect(layout)

    def wh(m):
        w = exact(torch.sqrt, torch.clamp_min(m[..., 2] * m[..., r], 1e-12))
        h = exact(torch.sqrt, torch.clamp_min(m[..., 2] / torch.clamp_min(m[..., r], 1e-12),
                                              1e-12))
        return w, h

    (w1, h1), (w2, h2) = wh(last_meas), wh(z2)
    gapf = torch.clamp_min(gap.to(torch.float32), 1.0)
    steps = [(z2[..., 0] - last_meas[..., 0]) / gapf, (z2[..., 1] - last_meas[..., 1]) / gapf,
             (w2 - w1) / gapf, (h2 - h1) / gapf]
    if layout.name == "xysr_obb":
        steps.append(wrap_angle(z2[..., 4] - last_meas[..., 4]) / gapf)
    elif layout.name == "xyscr":
        steps.append((z2[..., 3] - last_meas[..., 3]) / gapf)
    return w1, h1, steps


def _measurement(layout, last_meas, w1, h1, steps, i, mean):
    """The i-th interpolated measurement of every slot (oriented: aligned to
    the replay's mean)."""
    fi = float(i)
    xi = last_meas[..., 0] + fi * steps[0]
    yi = last_meas[..., 1] + fi * steps[1]
    wi = w1 + fi * steps[2]
    hi = h1 + fi * steps[3]
    si = torch.clamp_min(wi * hi, 1e-6)
    ri = torch.clamp_min(wi / torch.clamp_min(hi, 1e-12), 1e-6)
    if layout.name == "xyscr":
        return torch.stack([xi, yi, si, last_meas[..., 3] + fi * steps[4], ri], -1)
    if layout.name == "xysr_obb":
        zi = torch.stack([xi, yi, si, ri, wrap_angle(last_meas[..., 4] + fi * steps[4])], -1)
        return kalman.align_obb_xysr(zi, mean[..., :5])
    return torch.stack([xi, yi, si, ri], -1)


def masked_update(layout, mean, cov, z, act):
    """The ORU's masked update: ``kalman.update``, then, for oriented boxes,
    the angular velocity damped x0.8 where ``act`` (OC-SORT's)."""
    mean, cov = kalman.update(layout, mean, cov, z, act)
    if layout.name == "xysr_obb":
        theta_v = torch.where(act, mean[..., 8] * 0.8, mean[..., 8])
        mean = torch.cat([mean[..., :8], theta_v[..., None]], -1)
    return mean, cov


def oru_replay_plain(layout, mean, cov, frozen_mean, frozen_cov, last_meas, z2, rejoin, gap,
                     replayed):
    """The replay in plain PyTorch, for CPU tensors: the JAX loop over
    i = 1 .. min(the largest gap of a rejoining slot, MAX_ORU), each slot
    acting while i <= its gap.  Reads that bound on the host.

    mean, cov (S, K, dx) / (S, K, dx, dx) after this frame's predict;
    frozen_mean, frozen_cov likewise; last_meas, z2 (S, K, dz) (z2 already
    aligned to the predicted mean for oriented boxes); rejoin (S, K) bool;
    gap (S, K) int32 (misses + 1); replayed (S,) int32, added to in place.
    Returns (mean, cov).
    """
    replayed += rejoin.sum(dim=1, dtype=torch.int32)
    mean = torch.where(rejoin[..., None], frozen_mean, mean)
    cov = torch.where(rejoin[..., None, None], frozen_cov, cov)
    n_steps = min(int(torch.where(rejoin, gap, 0).max()), MAX_ORU) if rejoin.numel() else 0
    if n_steps == 0:
        return mean, cov
    w1, h1, steps = _interpolation(layout, last_meas, z2, gap)
    for i in range(1, n_steps + 1):
        act = rejoin & (i <= gap)
        if i > 1:
            mean, cov = kalman.predict(layout, mean, cov, act)
        zi = _measurement(layout, last_meas, w1, h1, steps, i, mean)
        mean, cov = masked_update(layout, mean, cov, zi, act)
    return mean, cov


@functools.lru_cache(maxsize=16)
def _noise(layout) -> ctypes.Array:
    """The layout's process and measurement variances as the kernel takes
    them: a float[dx + dz] of float32 values."""
    q_var, r_var = kalman.const_noise(layout)
    return (ctypes.c_float * (len(q_var) + len(r_var)))(*q_var, *r_var)


def _check(layout, tensors, rejoin, gap, replayed):
    if layout.name not in LAYOUT_TAGS:
        raise ValueError(f"oru_replay: needs an XYSR, XYSR-OBB or XYSCR layout, got "
                         f"{layout.name!r}")
    dx, dz = layout.dx, layout.dz
    S, K = rejoin.shape
    shapes = {"mean": (S, K, dx), "cov": (S, K, dx, dx), "frozen_mean": (S, K, dx),
              "frozen_cov": (S, K, dx, dx), "last_meas": (S, K, dz), "z2": (S, K, dz)}
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name] or t.dtype != torch.float32:
            raise ValueError(f"oru_replay: {name} must be {shapes[name]} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t, shape, dtype in (("rejoin", rejoin, (S, K), torch.bool),
                                  ("gap", gap, (S, K), torch.int32),
                                  ("replayed", replayed, (S,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"oru_replay: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    every = list(tensors.values()) + [rejoin, gap, replayed]
    if any(t.device != rejoin.device for t in every):
        raise ValueError("oru_replay: all tensors must be on one device")
    if not all(t.is_contiguous() for t in every):
        raise ValueError("oru_replay: inputs must be contiguous")


def oru_replay(layout, mean, cov, frozen_mean, frozen_cov, last_meas, z2, rejoin, gap, replayed):
    """(mean, cov) after the replay, as ``oru_replay_plain``; kernel K4 on a
    CUDA tensor (one launch, no host read)."""
    tensors = {"mean": mean, "cov": cov, "frozen_mean": frozen_mean, "frozen_cov": frozen_cov,
               "last_meas": last_meas, "z2": z2}
    _check(layout, tensors, rejoin, gap, replayed)
    dev = rejoin.device
    if dev.type == "cpu":
        return oru_replay_plain(layout, mean, cov, frozen_mean, frozen_cov, last_meas, z2, rejoin,
                                gap, replayed)
    if dev.type != "cuda":
        raise ValueError(f"oru_replay: unsupported device {dev}")
    S, K = rejoin.shape
    out_mean, out_cov = torch.empty_like(mean), torch.empty_like(cov)
    if rejoin.numel() == 0:
        return out_mean, out_cov
    fn = build.entry("oru", "bmt_oru", [_P] * 11 + [_P] + [_I] * 7 + [_P])
    with torch.cuda.device(dev):
        rc = fn(mean.data_ptr(), cov.data_ptr(), frozen_mean.data_ptr(), frozen_cov.data_ptr(),
                last_meas.data_ptr(), z2.data_ptr(), rejoin.data_ptr(), gap.data_ptr(),
                out_mean.data_ptr(), out_cov.data_ptr(), replayed.data_ptr(), _noise(layout),
                S, K, LAYOUT_TAGS[layout.name][0], MAX_ORU, *launch_geometry(S, K, layout.name),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("oru", "bmt_oru", rc)
    build.count_launch(oru_replay)
    return out_mean, out_cov


oru_replay.launches = 0


"""Batched, masked Kalman filter bank, XYAH (with NSA), XYWH(-OBB),
XYSR(-OBB), XYHR(-OBB) and XYSCR layouts (counterpart of
boxmot_tpu/motion/kalman.py).

Track state is ``mean (..., dx)`` and ``cov (..., dx, dx)`` with any
leading batch axes, here (S, K).  Every small product is written as
elementwise multiplies and adds in a fixed order, in the style of the JAX
``inv_psd_small``, and never as ``einsum``/``bmm``: a CPU ``einsum`` and a
cuBLAS ``bmm`` sum in different orders, and an ulp of difference in a
covariance can flip an association near-tie.  Written this way, and with
``sqrt`` and ``log`` correctly rounded (``ops.geometry.exact``), a CPU run
and a CUDA run of the port give the same bits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from boxmot_tpu_torch.ops.geometry import exact, wrap_angle


@dataclasses.dataclass(frozen=True)
class KFLayout:
    """Static description of one Kalman parameterization (mirror of the JAX
    ``KFLayout``).  The callables act on batched tensors."""

    name: str
    dx: int  # state dimension
    dz: int  # measurement dimension
    motion_mat: tuple  # (dx, dx) nested tuple, static
    init_mean: Callable  # (..., dz) -> (..., dx)
    init_cov_diag: Callable  # (..., dz) meas -> (..., dx) std
    process_diag: Callable  # (..., dx) mean -> (..., dx) std
    meas_diag: Callable  # (..., dx) mean -> (..., dz) std
    enforce: Callable  # (..., dx) mean -> (..., dx)
    nsa: bool = False  # scale the measurement noise by (1 - conf) on update


def _const_matmul(F: tuple, x: torch.Tensor, dim: int) -> torch.Tensor:
    """y[a] = sum_b F[a][b] * x[b] along ``dim`` for a static matrix F.

    Zero coefficients are skipped (adding an exact zero changes nothing)
    and unit ones are not multiplied, so the constant-velocity transition
    costs one add per position row.  Every row needs a nonzero entry.
    """
    rows = []
    for coeffs in F:
        acc = None
        for b, f in enumerate(coeffs):
            if f == 0.0:
                continue
            term = x.select(dim, b) if f == 1.0 else x.select(dim, b) * f
            acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows, dim=dim)


def _chol_lower(S: torch.Tensor, eps: float = 1e-9):
    """Unrolled Cholesky of (..., D, D); the lower factor as a D x D list
    of (...,) tensors.  The sqrt clamp stands in for a jittered repair."""
    D = S.shape[-1]
    L = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = S[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = exact(torch.sqrt, torch.clamp_min(s, eps))
            else:
                L[i][j] = s / L[j][j]
    return L


def inv_psd_small(S: torch.Tensor) -> torch.Tensor:
    """Inverse of small PSD matrices (..., D, D) through the unrolled Cholesky."""
    D = S.shape[-1]
    L = _chol_lower(S)
    zero = torch.zeros_like(S[..., 0, 0])
    # M = L^-1 (lower triangular), unrolled forward substitution.
    M = [[zero] * D for _ in range(D)]
    for i in range(D):
        M[i][i] = 1.0 / L[i][i]
        for j in range(i):
            s = L[i][j] * M[j][j]
            for k in range(j + 1, i):
                s = s + L[i][k] * M[k][j]
            M[i][j] = -s / L[i][i]
    # Sinv[a, b] = sum_k M[k][a] M[k][b]; the terms with k < max(a, b) are
    # exact zeros, so summing k upwards from 0 adds the nonzero terms in the
    # same order as the JAX unroll.
    Mt = torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)  # (..., D, D)
    out = Mt[..., 0, :, None] * Mt[..., 0, None, :]
    for k in range(1, D):
        out = out + Mt[..., k, :, None] * Mt[..., k, None, :]
    return out


def initiate(layout: KFLayout, meas: torch.Tensor):
    """(mean, cov) for new tracks from measurements (..., dz): mean = [z, 0],
    cov = diag(init std^2)."""
    mean = layout.enforce(layout.init_mean(meas))
    std = layout.init_cov_diag(meas)
    return mean, torch.diag_embed(torch.square(std))


def predict(layout: KFLayout, mean: torch.Tensor, cov: torch.Tensor, mask: torch.Tensor):
    """Masked predict; slots where ``mask`` is False pass through unchanged."""
    F = layout.motion_mat
    std = layout.process_diag(mean)
    new_mean = layout.enforce(_const_matmul(F, mean, -1))
    # F P F^T, then the process noise on the diagonal
    new_cov = _const_matmul(F, _const_matmul(F, cov, -2), -1)
    new_cov = new_cov + torch.diag_embed(torch.square(std))
    return (
        torch.where(mask[..., None], new_mean, mean),
        torch.where(mask[..., None, None], new_cov, cov),
    )


def update(layout: KFLayout, mean, cov, meas, mask, gain_scale=None, conf=None):
    """Masked correction step in Joseph form.

    meas (..., dz); slots where ``mask`` is False pass through unchanged.
    ``gain_scale`` (...,), when given, scales each slot's mean correction
    (OccluBoost's abnormal-motion suppression); the covariance still
    contracts in full.  ``conf`` (...,), the detections' confidences, scales
    the measurement noise's std by (1 - conf) under an NSA layout
    (StrongSORT's); other layouts ignore it.
    """
    dz, dx = layout.dz, layout.dx
    r_std = layout.meas_diag(mean)
    if layout.nsa:
        if conf is None:
            raise ValueError("update: an NSA layout needs each slot's conf")
        r_std = r_std * (1.0 - conf)[..., None]
    r_var = torch.square(r_std)

    Sinv = inv_psd_small(cov[..., :dz, :dz] + torch.diag_embed(r_var))
    # gain[a, z] = sum_d cov[a, d] Sinv[d, z]
    gain = cov[..., :, 0, None] * Sinv[..., None, 0, :]
    for d in range(1, dz):
        gain = gain + cov[..., :, d, None] * Sinv[..., None, d, :]

    innov = meas - mean[..., :dz]
    delta = innov[..., 0, None] * gain[..., :, 0]
    for z in range(1, dz):
        delta = delta + innov[..., z, None] * gain[..., :, z]
    if gain_scale is not None:
        delta = delta * gain_scale[..., None]
    new_mean = layout.enforce(mean + delta)

    # Joseph form: P = (I - K H) P (I - K H)^T + K R K^T with H = [I 0].
    eye = torch.eye(dx, dtype=cov.dtype, device=cov.device)
    A = torch.cat([eye[:, :dz] - gain, eye[:, dz:].expand(gain.shape[:-1] + (dx - dz,))], -1)
    AP = A[..., :, 0, None] * cov[..., None, 0, :]
    for b in range(1, dx):
        AP = AP + A[..., :, b, None] * cov[..., None, b, :]
    new_cov = AP[..., :, 0, None] * A[..., None, :, 0]
    for c in range(1, dx):
        new_cov = new_cov + AP[..., :, c, None] * A[..., None, :, c]
    gr = gain * r_var[..., None, :]
    krk = gr[..., :, 0, None] * gain[..., None, :, 0]
    for z in range(1, dz):
        krk = krk + gr[..., :, z, None] * gain[..., None, :, z]
    new_cov = new_cov + krk

    return (
        torch.where(mask[..., None], new_mean, mean),
        torch.where(mask[..., None, None], new_cov, cov),
    )


def gating_distance(layout: KFLayout, mean, cov, meas):
    """Squared Mahalanobis distance of every measurement to every projected
    state: mean (..., K, dx), cov (..., K, dx, dx), meas (..., N, dz) ->
    (..., K, N), d^T S^-1 d with S = H P H^T + R (no NSA scaling), summed as
    t_y = sum_z d_z Sinv[z, y], then sum_y t_y d_y."""
    dz = layout.dz
    r_var = torch.square(layout.meas_diag(mean))
    Sinv = inv_psd_small(cov[..., :dz, :dz] + torch.diag_embed(r_var))
    d = meas[..., None, :, :dz] - mean[..., :, None, :dz]  # (..., K, N, dz)
    out = None
    for y in range(dz):
        t = d[..., 0] * Sinv[..., 0, y, None]
        for z in range(1, dz):
            t = t + d[..., z] * Sinv[..., z, y, None]
        out = t * d[..., y] if out is None else out + t * d[..., y]
    return out


_SWP = 1.0 / 20  # std weight of the position
_SWV = 1.0 / 160  # std weight of the velocity


def _cv_motion_mat(dz: int) -> tuple:
    """Constant-velocity [[I, I], [0, I]] transition as a nested tuple."""
    n = 2 * dz
    return tuple(
        tuple(1.0 if (b == a or b == a + dz) else 0.0 for b in range(n)) for a in range(n)
    )


def _set(x: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., :i], v[..., None], x[..., i + 1:]], dim=-1)


def make_xyah_layout(std_weight_position: float = _SWP,
                     std_weight_velocity: float = _SWV, nsa: bool = False) -> KFLayout:
    """[cx, cy, a=w/h, h] constant-velocity filter (ByteTrack and StrongSORT
    lineage); ``nsa`` scales the measurement noise by (1 - conf) on update.

    The JAX factory's ``obb`` branch is not ported: OBB ByteTrack runs on
    ``make_xywh_layout(obb=True)``.
    """
    swp, swv = std_weight_position, std_weight_velocity

    def init_mean(z):
        return torch.cat([z, torch.zeros_like(z)], dim=-1)

    def init_cov_diag(z):
        h = z[..., 3]
        c2, c5 = torch.full_like(h, 1e-2), torch.full_like(h, 1e-5)
        return torch.stack([2 * swp * h, 2 * swp * h, c2, 2 * swp * h,
                            10 * swv * h, 10 * swv * h, c5, 10 * swv * h], dim=-1)

    def process_diag(mean):
        h = mean[..., 3]
        c2, c5 = torch.full_like(h, 1e-2), torch.full_like(h, 1e-5)
        return torch.stack([swp * h, swp * h, c2, swp * h,
                            swv * h, swv * h, c5, swv * h], dim=-1)

    def meas_diag(mean):
        h = mean[..., 3]
        return torch.stack([swp * h, swp * h, torch.full_like(h, 1e-1), swp * h], dim=-1)

    def enforce(mean):
        mean = _set(mean, 2, torch.clamp_min(mean[..., 2], 1e-4))
        return _set(mean, 3, torch.clamp_min(mean[..., 3], 1e-4))

    return KFLayout(
        name="xyah",
        dx=8,
        dz=4,
        motion_mat=_cv_motion_mat(4),
        init_mean=init_mean,
        init_cov_diag=init_cov_diag,
        process_diag=process_diag,
        meas_diag=meas_diag,
        enforce=enforce,
        nsa=nsa,
    )


def make_xywh_layout(obb: bool = False, std_weight_position: float = _SWP,
                     std_weight_velocity: float = _SWV) -> KFLayout:
    """[cx, cy, w, h] (+ theta) constant-velocity filter (ByteTrack-OBB)."""
    dz = 5 if obb else 4
    swp, swv = std_weight_position, std_weight_velocity

    def init_mean(z):
        if obb:
            z = _set(z, 4, wrap_angle(z[..., 4]))
        return torch.cat([z, torch.zeros_like(z)], dim=-1)

    def _wh_stack(m, kp, kv, theta_p, theta_v):
        w, h = m[..., 2], m[..., 3]
        pos = [kp * w, kp * h, kp * w, kp * h]
        vel = [kv * w, kv * h, kv * w, kv * h]
        if obb:
            pos.append(torch.full_like(w, theta_p))
            vel.append(torch.full_like(w, theta_v))
        return torch.stack(pos + vel, dim=-1)

    def init_cov_diag(z):
        return _wh_stack(z, 2 * swp, 10 * swv, 1e-2, 1e-5)

    def process_diag(mean):
        return _wh_stack(mean, swp, swv, 1e-2, 1e-5)

    def meas_diag(mean):
        w, h = mean[..., 2], mean[..., 3]
        std = [swp * w, swp * h, swp * w, swp * h]
        if obb:
            std.append(torch.full_like(w, 1e-1))
        return torch.stack(std, dim=-1)

    def enforce(mean):
        mean = _set(mean, 2, torch.clamp_min(mean[..., 2], 1e-4))
        mean = _set(mean, 3, torch.clamp_min(mean[..., 3], 1e-4))
        if obb:
            mean = _set(mean, 4, wrap_angle(mean[..., 4]))
        return mean

    return KFLayout(
        name="xywh_obb" if obb else "xywh",
        dx=2 * dz,
        dz=dz,
        motion_mat=_cv_motion_mat(dz),
        init_mean=init_mean,
        init_cov_diag=init_cov_diag,
        process_diag=process_diag,
        meas_diag=meas_diag,
        enforce=enforce,
    )


def _std_stds(values) -> tuple:
    """float64 square roots of the noise variances, as the JAX factories
    take them (rounded to float32 where a tensor is made of them)."""
    return tuple(math.sqrt(v) for v in values)


@functools.lru_cache(maxsize=None)
def _const_row(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 row of constants on ``device``, made once and filled in
    place: a fill is a kernel, where a tensor made from host data would be a
    copy from host memory, which a replay must not make."""
    row = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        row[i].fill_(v)
    return row


def _const(values: tuple, like: torch.Tensor) -> torch.Tensor:
    """The constant row ``values`` on ``like``'s device, broadcast to its
    leading axes."""
    return _const_row(values, like.device).expand(like.shape[:-1] + (len(values),))


def make_xysr_layout(obb: bool = False, q_xy_scaling: float = 0.01, q_s_scaling: float = 0.0001,
                     q_a_scaling: float = 0.0001) -> KFLayout:
    """[cx, cy, s=area, r=aspect] (+ theta) SORT-style filter with OC-SORT's
    constant Q, R and P0; r has no velocity.  State: x, y, s, r, vx, vy, vs
    (OBB: x, y, s, r, theta, vx, vy, vs, vtheta)."""
    dz = 5 if obb else 4
    dx = 9 if obb else 7
    vel_of = {0: dz, 1: dz + 1, 2: dz + 2}  # position index -> its velocity
    if obb:
        vel_of[4] = 8
        p0 = [10.0] * 5 + [10000.0] * 4
        q = [1.0] * 5 + [q_xy_scaling, q_xy_scaling, q_s_scaling, q_a_scaling]
        r = [1.0, 1.0, 10.0, 10.0, 10.0]
    else:
        p0 = [10.0] * 4 + [10000.0] * 3
        q = [1.0] * 4 + [q_xy_scaling, q_xy_scaling, q_s_scaling]
        r = [1.0, 1.0, 10.0, 10.0]
    # JAX scales np.ones by the factor: 1.0 * q, which is q itself
    F = tuple(tuple(1.0 if (b == a or vel_of.get(a) == b) else 0.0 for b in range(dx))
              for a in range(dx))
    p0_std, q_std, r_std = _std_stds(p0), _std_stds(q), _std_stds(r)

    def init_mean(z):
        return torch.cat([z, z.new_zeros(z.shape[:-1] + (dx - dz,))], dim=-1)

    def enforce(mean):
        mean = _set(mean, 2, torch.clamp_min(mean[..., 2], 1e-6))
        mean = _set(mean, 3, torch.clamp_min(mean[..., 3], 1e-6))
        if obb:
            mean = _set(mean, 4, wrap_angle(mean[..., 4]))
        return mean

    return KFLayout(
        name="xysr_obb" if obb else "xysr",
        dx=dx,
        dz=dz,
        motion_mat=F,
        init_mean=init_mean,
        init_cov_diag=lambda z: _const(p0_std, z),
        process_diag=lambda mean: _const(q_std, mean),
        meas_diag=lambda mean: _const(r_std, mean),
        enforce=enforce,
    )


def make_xyhr_layout(obb: bool = False) -> KFLayout:
    """[x, y, h, r=w/h] (+ theta) constant-velocity filter with BoostTrack's
    constant noise: P0 = 10 (10000 for the velocities), Q = 1 (0.01 for the
    velocities and theta), R = [1, 1, 10, 0.01] (+ 0.01 for theta)."""
    dz = 5 if obb else 4
    dx = 2 * dz
    p0 = [10.0] * dz + [10000.0] * dz
    q = [1.0] * dz + [0.01] * dz
    r = [1.0, 1.0, 10.0, 0.01]
    if obb:
        q[4] = 0.01
        r.append(0.01)
    p0_std, q_std, r_std = _std_stds(p0), _std_stds(q), _std_stds(r)

    def init_mean(z):
        if obb:
            z = _set(z, 4, wrap_angle(z[..., 4]))
        return torch.cat([z, torch.zeros_like(z)], dim=-1)

    def enforce(mean):
        mean = _set(mean, 2, torch.clamp_min(mean[..., 2], 1e-4))
        mean = _set(mean, 3, torch.clamp_min(mean[..., 3], 1e-4))
        if obb:
            mean = _set(mean, 4, wrap_angle(mean[..., 4]))
        return mean

    return KFLayout(
        name="xyhr_obb" if obb else "xyhr",
        dx=dx,
        dz=dz,
        motion_mat=_cv_motion_mat(dz),
        init_mean=init_mean,
        init_cov_diag=lambda z: _const(p0_std, z),
        process_diag=lambda mean: _const(q_std, mean),
        meas_diag=lambda mean: _const(r_std, mean),
        enforce=enforce,
    )


def make_xyscr_layout() -> KFLayout:
    """[x, y, s=area, c=confidence, r=aspect] score-aware filter of HybridSORT:
    9-D state [x, y, s, c, r, vx, vy, vs, vc] with velocities on x, y, s and
    c and none on r; constant P0 = 10 (10000 for the velocities), Q = 1 (0.01
    for vx and vy, 1e-4 for vs and vc) and R = [1, 1, 10, 10, 10]; s and r
    clamped at 1e-6."""
    dz, dx = 5, 9
    vel_of = {0: 5, 1: 6, 2: 7, 3: 8}  # position index -> its velocity
    F = tuple(tuple(1.0 if (b == a or vel_of.get(a) == b) else 0.0 for b in range(dx))
              for a in range(dx))
    p0 = [10.0] * 5 + [10000.0] * 4
    q = [1.0] * 5 + [0.01, 0.01, 1e-4, 1e-4]
    r = [1.0, 1.0, 10.0, 10.0, 10.0]
    p0_std, q_std, r_std = _std_stds(p0), _std_stds(q), _std_stds(r)

    def init_mean(z):
        return torch.cat([z, z.new_zeros(z.shape[:-1] + (dx - dz,))], dim=-1)

    def enforce(mean):
        mean = _set(mean, 2, torch.clamp_min(mean[..., 2], 1e-6))
        return _set(mean, 4, torch.clamp_min(mean[..., 4], 1e-6))

    return KFLayout(
        name="xyscr",
        dx=dx,
        dz=dz,
        motion_mat=F,
        init_mean=init_mean,
        init_cov_diag=lambda z: _const(p0_std, z),
        process_diag=lambda mean: _const(q_std, mean),
        meas_diag=lambda mean: _const(r_std, mean),
        enforce=enforce,
    )


def const_noise(layout: KFLayout) -> tuple[list, list]:
    """(process variances (dx,), measurement variances (dz,)) of a constant-
    noise layout (XYSR, XYSR-OBB, XYHR, XYSCR) as float32 values: each std rounded to float32 and squared
    in float32, as ``predict`` and ``update`` square them."""
    probe = torch.zeros(1, layout.dx)
    q_var = torch.square(layout.process_diag(probe))[0]
    r_var = torch.square(layout.meas_diag(probe))[0]
    return q_var.tolist(), r_var.tolist()


def align_obb_xysr(z: torch.Tensor, ref: torch.Tensor, size_weight: float = 0.05):
    """Resolve the 4-way OBB parameterization in XYSR space: z, ref (..., 5)
    [cx, cy, s, r, theta]; (s, r, th), (s, r, th + pi), (s, 1/r, th + pi/2)
    and (s, 1/r, th - pi/2) are one rectangle; take the candidate with the
    least |wrapped angle delta| + size_weight * |log(r / ref_r)| (the first
    one on a tie, as ``jnp.argmin``)."""
    eps = 1e-6
    r = torch.clamp_min(z[..., 3], eps)
    th = wrap_angle(z[..., 4])
    ref_r = torch.clamp_min(ref[..., 3], eps)
    ref_th = ref[..., 4, None]

    inv_r = 1.0 / r
    cand_r = torch.stack([r, r, inv_r, inv_r], dim=-1)
    cand_t = torch.stack([th, th + math.pi, th + math.pi / 2, th - math.pi / 2], dim=-1)
    aligned_t = ref_th + wrap_angle(cand_t - ref_th)
    angle_cost = torch.abs(aligned_t - ref_th)
    size_cost = torch.abs(exact(torch.log, cand_r / ref_r[..., None]))
    best = torch.argmin(angle_cost + size_weight * size_cost, dim=-1, keepdim=True)

    def take(c):
        return torch.gather(c, -1, best)[..., 0]

    return torch.stack([z[..., 0], z[..., 1], torch.clamp_min(z[..., 2], eps),
                        torch.clamp_min(take(cand_r), eps), take(aligned_t)], dim=-1)


def align_obb_to_ref(meas: torch.Tensor, ref: torch.Tensor, size_weight: float = 0.05):
    """Resolve the 4-way OBB parameterization of meas (..., 5) [cx, cy, w, h,
    theta] against ref (..., 5): (w, h, th), (w, h, th + pi), (h, w, th + pi/2)
    and (h, w, th - pi/2) are one rectangle; take the candidate with the
    least |wrapped angle delta| + size_weight * log-size difference (the
    first one on a tie, as ``jnp.argmin``)."""
    eps = 1e-6
    w = torch.clamp_min(meas[..., 2], eps)
    h = torch.clamp_min(meas[..., 3], eps)
    th = meas[..., 4]
    ref_w = torch.clamp_min(ref[..., 2], eps)
    ref_h = torch.clamp_min(ref[..., 3], eps)
    ref_th = ref[..., 4, None]

    cand_w = torch.stack([w, w, h, h], dim=-1)
    cand_h = torch.stack([h, h, w, w], dim=-1)
    cand_t = torch.stack([th, th + math.pi, th + math.pi / 2, th - math.pi / 2], dim=-1)
    aligned_t = ref_th + wrap_angle(cand_t - ref_th)
    angle_cost = torch.abs(aligned_t - ref_th)
    size_cost = (torch.abs(exact(torch.log, cand_w / ref_w[..., None]))
                 + torch.abs(exact(torch.log, cand_h / ref_h[..., None])))
    best = torch.argmin(angle_cost + size_weight * size_cost, dim=-1, keepdim=True)

    def take(c):
        return torch.gather(c, -1, best)[..., 0]

    return torch.stack([meas[..., 0], meas[..., 1], take(cand_w), take(cand_h),
                        take(aligned_t)], dim=-1)

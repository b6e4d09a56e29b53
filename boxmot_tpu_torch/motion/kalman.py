"""Batched, masked Kalman filter bank, XYAH layout (counterpart of
boxmot_tpu/motion/kalman.py).

Track state is ``mean (..., dx)`` and ``cov (..., dx, dx)`` with any
leading batch axes, here (S, K).  Every small product is written as
elementwise multiplies and adds in a fixed order, in the style of the JAX
``inv_psd_small``, and never as ``einsum``/``bmm``: a CPU ``einsum`` and a
cuBLAS ``bmm`` sum in different orders, and an ulp of difference in a
covariance can flip an association near-tie.  Written this way, a CPU run
and a CUDA run of the port give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class KFLayout:
    """Static description of one Kalman parameterization (mirror of the JAX
    ``KFLayout`` without its NSA option, which no ported tracker uses).  The
    callables act on batched tensors."""

    name: str
    dx: int  # state dimension
    dz: int  # measurement dimension
    motion_mat: tuple  # (dx, dx) nested tuple, static
    init_mean: Callable  # (..., dz) -> (..., dx)
    init_cov_diag: Callable  # (..., dz) meas -> (..., dx) std
    process_diag: Callable  # (..., dx) mean -> (..., dx) std
    meas_diag: Callable  # (..., dx) mean -> (..., dz) std
    enforce: Callable  # (..., dx) mean -> (..., dx)


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
                L[i][j] = torch.sqrt(torch.clamp_min(s, eps))
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


def update(layout: KFLayout, mean, cov, meas, mask):
    """Masked correction step in Joseph form.

    meas (..., dz); slots where ``mask`` is False pass through unchanged.
    """
    dz, dx = layout.dz, layout.dx
    r_var = torch.square(layout.meas_diag(mean))

    Sinv = inv_psd_small(cov[..., :dz, :dz] + torch.diag_embed(r_var))
    # gain[a, z] = sum_d cov[a, d] Sinv[d, z]
    gain = cov[..., :, 0, None] * Sinv[..., None, 0, :]
    for d in range(1, dz):
        gain = gain + cov[..., :, d, None] * Sinv[..., None, d, :]

    innov = meas - mean[..., :dz]
    delta = innov[..., 0, None] * gain[..., :, 0]
    for z in range(1, dz):
        delta = delta + innov[..., z, None] * gain[..., :, z]
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
                     std_weight_velocity: float = _SWV) -> KFLayout:
    """[cx, cy, a=w/h, h] constant-velocity filter (ByteTrack lineage).

    The JAX factory's ``obb`` branch (a fifth, angle, dimension) comes with
    OBB ByteTrack.
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
    )

"""The port's Kalman bank (XYAH with and without NSA, the gate, XYSCR, and
XYHR with OccluBoost's gain scale) against the JAX bank and the float64
oracle.

The same numpy tracks and measurements go through ``boxmot_tpu.motion.kalman``
and ``boxmot_tpu_torch.motion.kalman``.  The predict's transition products
have two nonzero terms, so predict is bit-equal; the update's products are
summed in another order than XLA's dots, so it is held at rtol 1e-5 (with
an absolute floor for entries that cancel to near zero).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.motion import kalman as jk
from boxmot_tpu_torch.motion import kalman as tk
from tests.oracle.kalman_np import XYAHOracle

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _meas(rng, n):
    xy = rng.uniform(50, 1800, (n, 2))
    a = rng.uniform(0.25, 0.7, (n, 1))
    h = rng.uniform(20, 300, (n, 1))
    return np.concatenate([xy, a, h], axis=1).astype(np.float32)


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _bank(rng, n):
    """(mean, cov) after initiate + a few predict/update rounds on the JAX bank."""
    jl = jk.make_xyah_layout()
    z = jnp.asarray(_meas(rng, n))
    mean, cov = jk.initiate(jl, z)
    ones = jnp.ones((n,), bool)
    for _ in range(3):
        mean, cov = jk.predict(jl, mean, cov, ones)
        z = z + jnp.asarray(rng.normal(0, 2, (n, 4)).astype(np.float32)) * jnp.asarray([1, 1, 0.001, 1])
        mean, cov = jk.update(jl, mean, cov, z, jnp.zeros((n,)), ones)
    return np.array(mean), np.array(cov)


def test_motion_matrix_mirrors_jax():
    assert tk._cv_motion_mat(4) == jk._cv_motion_mat(4)
    tl, jl = tk.make_xyah_layout(), jk.make_xyah_layout()
    assert (tl.dx, tl.dz, tl.motion_mat) == (jl.dx, jl.dz, jl.motion_mat)
    assert tl.nsa == jl.nsa is False
    tn, jn = tk.make_xyah_layout(nsa=True), jk.make_xyah_layout(nsa=True)
    assert (tn.name, tn.dx, tn.dz, tn.motion_mat, tn.nsa) == (jn.name, jn.dx, jn.dz, jn.motion_mat, True)


def test_initiate_bit_equal_to_jax_and_close_to_oracle():
    rng = np.random.default_rng(0)
    z = _meas(rng, 64)
    jm, jc = jk.initiate(jk.make_xyah_layout(), jnp.asarray(z))
    tm, tc = tk.initiate(tk.make_xyah_layout(), torch.from_numpy(z))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    oracle = XYAHOracle()
    for i in range(8):
        om, oc = oracle.initiate(z[i].astype(np.float64))
        _close(tm[i].numpy(), om, 1.0)
        _close(tc[i].numpy(), oc, float(np.abs(oc).max()))


@pytest.mark.parametrize("masked", [False, True])
def test_predict_bit_equal_to_jax(masked):
    rng = np.random.default_rng(1)
    mean, cov = _bank(rng, 48)
    mask = rng.uniform(size=48) < 0.6 if masked else np.ones(48, bool)
    jm, jc = jk.predict(jk.make_xyah_layout(), jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(mask))
    tm, tc = tk.predict(tk.make_xyah_layout(), torch.from_numpy(mean), torch.from_numpy(cov),
                        torch.from_numpy(mask))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("masked", [False, True])
def test_update_close_to_jax(masked):
    rng = np.random.default_rng(2)
    mean, cov = _bank(rng, 48)
    z = (mean[:, :4] + rng.normal(0, 3, (48, 4)) * [1, 1, 0.001, 1]).astype(np.float32)
    mask = rng.uniform(size=48) < 0.6 if masked else np.ones(48, bool)
    conf = np.zeros(48, np.float32)
    jm, jc = jk.update(jk.make_xyah_layout(), *map(jnp.asarray, (mean, cov, z, conf, mask)))
    tm, tc = tk.update(tk.make_xyah_layout(), *map(torch.from_numpy, (mean, cov, z, mask)))
    for i in range(48):
        _close(tm[i].numpy(), np.asarray(jm[i]), float(np.abs(mean[i]).max()))
        _close(tc[i].numpy(), np.asarray(jc[i]), float(np.abs(cov[i]).max()))
    # masked-out slots pass through untouched
    np.testing.assert_array_equal(tm.numpy()[~mask], mean[~mask])
    np.testing.assert_array_equal(tc.numpy()[~mask], cov[~mask])


def test_predict_and_update_close_to_oracle():
    """One predict and one update from the same state, float32 against the
    float64 oracle."""
    rng = np.random.default_rng(3)
    mean, cov = _bank(rng, 8)
    z = (mean[:, :4] + rng.normal(0, 3, (8, 4)) * [1, 1, 0.001, 1]).astype(np.float32)
    layout, oracle = tk.make_xyah_layout(), XYAHOracle()
    ones = torch.ones(8, dtype=torch.bool)
    pm, pc = tk.predict(layout, torch.from_numpy(mean), torch.from_numpy(cov), ones)
    um, uc = tk.update(layout, pm, pc, torch.from_numpy(z), ones)
    for i in range(8):
        om, oc = oracle.predict(mean[i].astype(np.float64), cov[i].astype(np.float64))
        _close(pm[i].numpy(), om, float(np.abs(om).max()))
        _close(pc[i].numpy(), oc, float(np.abs(oc).max()))
        om, oc = oracle.update(pm[i].numpy().astype(np.float64), pc[i].numpy().astype(np.float64),
                               z[i].astype(np.float64))
        _close(um[i].numpy(), om, float(np.abs(om).max()))
        _close(uc[i].numpy(), oc, float(np.abs(oc).max()))


def test_inv_psd_small_close_to_jax_and_numpy():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(32, 4, 4))
    S = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(4)).astype(np.float32)
    got = tk.inv_psd_small(torch.from_numpy(S)).numpy()
    want = np.asarray(jk.inv_psd_small(jnp.asarray(S)))
    exact = np.linalg.inv(S.astype(np.float64))
    for g, w, e in zip(got, want, exact):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale)
        np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-4 * scale)


def _xyhr_bank(rng, n, obb):
    """An XYHR (+ theta) bank after initiate and three predict/update rounds
    on the JAX layout, with its last measurements."""
    jl = jk.make_xyhr_layout(obb=obb)
    z = np.concatenate([rng.uniform(50, 1800, (n, 2)), rng.uniform(20, 300, (n, 1)),
                        rng.uniform(0.25, 0.7, (n, 1))]
                       + ([rng.uniform(-4, 4, (n, 1))] if obb else []), 1).astype(np.float32)
    mean, cov = jk.initiate(jl, jnp.asarray(z))
    ones = jnp.ones((n,), bool)
    for _ in range(3):
        mean, cov = jk.predict(jl, mean, cov, ones)
        step = rng.normal(0, 2, z.shape) * ([1, 1, 1, 0.001] + ([0.01] if obb else []))
        z = (z + step).astype(np.float32)
        mean, cov = jk.update(jl, mean, cov, jnp.asarray(z), jnp.zeros((n,)), ones)
    return np.array(mean), np.array(cov), z


@pytest.mark.parametrize("obb", [False, True], ids=["xyhr", "xyhr-obb"])
def test_xyhr_layout_equals_jax(obb):
    """BoostTrack's and OccluBoost's XYHR layout: the structure and constant
    noise rows equal, initiate and predict bit-equal, update at rtol 1e-5."""
    jl, tl = jk.make_xyhr_layout(obb=obb), tk.make_xyhr_layout(obb=obb)
    assert (tl.name, tl.dx, tl.dz, tl.motion_mat) == (jl.name, jl.dx, jl.dz, jl.motion_mat)
    rng = np.random.default_rng(5 + obb)
    mean, cov, z = _xyhr_bank(rng, 48, obb)
    probe = np.zeros((2, tl.dx), np.float32)
    for fn in ("init_cov_diag", "process_diag", "meas_diag"):
        arg = probe[:, :tl.dz] if fn == "init_cov_diag" else probe
        np.testing.assert_array_equal(getattr(tl, fn)(torch.from_numpy(arg)).numpy(),
                                      np.asarray(getattr(jl, fn)(jnp.asarray(arg))), err_msg=fn)
    z0 = z.copy()
    if obb:
        z0[:, 4] += 7.0  # initiate wraps theta
    jm, jc = jk.initiate(jl, jnp.asarray(z0))
    tm, tc = tk.initiate(tl, torch.from_numpy(z0))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    mask = rng.uniform(size=48) < 0.7
    jm, jc = jk.predict(jl, jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(mask))
    tm, tc = tk.predict(tl, torch.from_numpy(mean), torch.from_numpy(cov), torch.from_numpy(mask))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jm, jc = jk.update(jl, *map(jnp.asarray, (mean, cov, z, np.zeros(48, np.float32), mask)))
    tm, tc = tk.update(tl, *map(torch.from_numpy, (mean, cov, z, mask)))
    for i in range(48):
        _close(tm[i].numpy(), np.asarray(jm[i]), float(np.abs(mean[i]).max()))
        _close(tc[i].numpy(), np.asarray(jc[i]), float(np.abs(cov[i]).max()))


def test_update_gain_scale_equals_jax():
    """OccluBoost's AMS gain: a per-slot scale of the mean's correction only,
    against the JAX update; without it the update's bits are unchanged."""
    rng = np.random.default_rng(7)
    mean, cov, z = _xyhr_bank(rng, 48, False)
    z = (z + rng.normal(0, 6, z.shape) * [1, 1, 1, 0.001]).astype(np.float32)
    mask = rng.uniform(size=48) < 0.8
    scale = np.where(rng.uniform(size=48) < 0.5, 1.0, rng.uniform(0.2, 1.0, 48)).astype(np.float32)
    jl, tl = jk.make_xyhr_layout(), tk.make_xyhr_layout()
    jm, jc = jk.update(jl, *map(jnp.asarray, (mean, cov, z, np.zeros(48, np.float32), mask)),
                       gain_scale=jnp.asarray(scale))
    tm, tc = tk.update(tl, *map(torch.from_numpy, (mean, cov, z, mask)),
                       gain_scale=torch.from_numpy(scale))
    for i in range(48):
        _close(tm[i].numpy(), np.asarray(jm[i]), float(np.abs(mean[i]).max()))
        _close(tc[i].numpy(), np.asarray(jc[i]), float(np.abs(cov[i]).max()))
    um, uc = tk.update(tl, *map(torch.from_numpy, (mean, cov, z, mask)))
    np.testing.assert_array_equal(tc.numpy(), uc.numpy())  # the covariance contracts in full
    ones = torch.ones(48)
    np.testing.assert_array_equal(
        tk.update(tl, *map(torch.from_numpy, (mean, cov, z, mask)), gain_scale=ones)[0].numpy(),
        um.numpy())
    damped = mask & (scale < 1)
    assert damped.sum() > 10
    assert not np.allclose(tm.numpy()[damped], um.numpy()[damped])


def test_nsa_update_with_conf_equals_jax():
    """StrongSORT's NSA update: the measurement std scaled by 1 - conf, held
    to the JAX update at rtol 1e-5; with conf 0 it is the plain update to
    the bit, and an NSA layout refuses a missing conf."""
    rng = np.random.default_rng(11)
    mean, cov = _bank(rng, 48)
    z = (mean[:, :4] + rng.normal(0, 3, (48, 4)) * [1, 1, 0.001, 1]).astype(np.float32)
    mask = rng.uniform(size=48) < 0.7
    conf = rng.uniform(0.1, 0.95, 48).astype(np.float32)
    jl, tl = jk.make_xyah_layout(nsa=True), tk.make_xyah_layout(nsa=True)
    jm, jc = jk.update(jl, *map(jnp.asarray, (mean, cov, z, conf, mask)))
    args = tuple(map(torch.from_numpy, (mean, cov, z, mask)))
    tm, tc = tk.update(tl, *args, conf=torch.from_numpy(conf))
    for i in range(48):
        _close(tm[i].numpy(), np.asarray(jm[i]), float(np.abs(mean[i]).max()))
        _close(tc[i].numpy(), np.asarray(jc[i]), float(np.abs(cov[i]).max()))
    plain = tk.update(tk.make_xyah_layout(), *args)
    nsa0 = tk.update(tl, *args, conf=torch.zeros(48))
    for g, w in zip(nsa0, plain):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert not np.array_equal(tc.numpy()[mask], plain[1].numpy()[mask])  # the scale acts
    with pytest.raises(ValueError, match="conf"):
        tk.update(tl, *args)


@pytest.mark.parametrize("layout", ["xyah", "xyhr", "xyscr"])
def test_update_without_conf_unchanged(layout):
    """A layout without NSA ignores ``conf``: the update's bits are those of
    the update without it."""
    rng = np.random.default_rng(12)
    tl = getattr(tk, f"make_{layout}_layout")()
    z0 = np.abs(rng.normal(50, 20, (32, tl.dz))).astype(np.float32)
    mean, cov = tk.initiate(tl, torch.from_numpy(z0))
    mask = torch.from_numpy(rng.uniform(size=32) < 0.7)
    mean, cov = tk.predict(tl, mean, cov, mask)
    z = torch.from_numpy((z0 * rng.uniform(0.95, 1.05, z0.shape)).astype(np.float32))
    want = tk.update(tl, mean, cov, z, mask)
    got = tk.update(tl, mean, cov, z, mask, conf=torch.from_numpy(rng.uniform(size=32).astype(np.float32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_gating_distance_equals_jax_and_numpy():
    """The squared Mahalanobis gate of a predicted XYAH bank (K, N) at rtol
    1e-5 against the JAX gate and float64 numpy, batched over S."""
    rng = np.random.default_rng(13)
    mean, cov = _bank(rng, 24)
    layout_j, layout_t = jk.make_xyah_layout(nsa=True), tk.make_xyah_layout(nsa=True)
    meas = _meas(rng, 17)
    meas[:8] = mean[:8, :4] + rng.normal(0, 2, (8, 4)).astype(np.float32) * [1, 1, 0.01, 1]
    want = np.asarray(jk.gating_distance(layout_j, *map(jnp.asarray, (mean, cov, meas))))
    got = tk.gating_distance(layout_t, *(torch.from_numpy(np.stack([a, a])) for a in (mean, cov, meas)))
    assert got.shape == (2, 24, 17)
    np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), want, rtol=RTOL, atol=1e-3)
    h = mean[:, 3].astype(np.float64)
    r = np.stack([h / 20, h / 20, np.full_like(h, 0.1), h / 20], 1) ** 2
    S = cov[:, :4, :4].astype(np.float64) + np.eye(4) * r[:, None, :]
    d = meas[None, :, :].astype(np.float64) - mean[:, None, :4]
    exact = np.einsum("knz,kzy,kny->kn", d, np.linalg.inv(S), d)
    np.testing.assert_allclose(got[0].numpy(), exact, rtol=1e-4, atol=1e-3)
    assert (want < 9.4877).any() and (want > 9.4877).any()  # both sides of chi2(4)


def test_xyscr_layout_equals_jax():
    """HybridSORT's XYSCR layout: structure and constant noise rows equal,
    initiate and predict bit-equal, update at rtol 1e-5, clamps of s and r."""
    jl, tl = jk.make_xyscr_layout(), tk.make_xyscr_layout()
    assert (tl.name, tl.dx, tl.dz, tl.motion_mat, tl.nsa) == (jl.name, jl.dx, jl.dz, jl.motion_mat, False)
    probe = np.zeros((2, 9), np.float32)
    for fn in ("init_cov_diag", "process_diag", "meas_diag"):
        arg = probe[:, :5] if fn == "init_cov_diag" else probe
        np.testing.assert_array_equal(getattr(tl, fn)(torch.from_numpy(arg)).numpy(),
                                      np.asarray(getattr(jl, fn)(jnp.asarray(arg))), err_msg=fn)
    rng = np.random.default_rng(14)
    n = 48
    w, h = rng.uniform(10, 200, n), rng.uniform(10, 200, n)
    z = np.stack([rng.uniform(0, 1800, n), rng.uniform(0, 1000, n), w * h,
                  rng.uniform(0.2, 0.95, n), w / h], 1).astype(np.float32)
    jm, jc = jk.initiate(jl, jnp.asarray(z))
    tm, tc = tk.initiate(tl, torch.from_numpy(z))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    mask = rng.uniform(size=n) < 0.7
    for step in range(3):
        jm, jc = jk.predict(jl, jm, jc, jnp.asarray(mask))
        tm, tc = tk.predict(tl, tm, tc, torch.from_numpy(mask))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        z = (z * rng.uniform(0.97, 1.03, z.shape)).astype(np.float32)
        jm, jc = jk.update(jl, jm, jc, jnp.asarray(z), jnp.zeros((n,)), jnp.asarray(mask))
        tm, tc = tk.update(tl, tm, tc, torch.from_numpy(z), torch.from_numpy(mask))
        for i in range(n):
            _close(tm[i].numpy(), np.asarray(jm[i]), float(np.abs(np.asarray(jm[i])).max()))
            _close(tc[i].numpy(), np.asarray(jc[i]), float(np.abs(np.asarray(jc[i])).max()))
        tm, tc = torch.from_numpy(np.array(jm)), torch.from_numpy(np.array(jc))
    low = np.array(jm)
    low[:4, 2], low[:4, 4] = -5.0, -1e-9
    np.testing.assert_array_equal(tl.enforce(torch.from_numpy(low)).numpy(),
                                  np.asarray(jl.enforce(jnp.asarray(low))))
    assert (tl.enforce(torch.from_numpy(low)).numpy()[:4, [2, 4]] == np.float32(1e-6)).all()

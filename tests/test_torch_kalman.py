"""The port's XYAH Kalman bank against the JAX bank and the float64 oracle.

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
    assert not jl.nsa  # the port's bank has no NSA option


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

"""The port's camera-motion compensation against the JAX package.

* ``downscale`` against ``jax.image.resize(..., "linear")`` (antialiased)
  within 1e-4 a pixel on [0, 255] images, at ECC's scale 0.15 of 1080p,
  720p and 300 x 400 frames, and at an upscale;
* ``ecc_align`` against the JAX ``ecc_align`` on seeded textured images
  shifted by known sub-pixel amounts, in translation and euclidean mode:
  warps within 1e-3 px or rad, and near the known motion;
* ``ECC.apply`` over a frame sequence against the JAX ``ECC``;
* SOF's numpy path (cv2 forced off on both) warp for warp against the JAX
  copy; the registry and ``create_cmc``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from boxmot_tpu.motion import cmc as jcmc
from boxmot_tpu_torch.motion import cmc as tcmc

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def textured(rng, h, w, sigma=2.0):
    """A smooth random texture in [0, 255]."""
    t = gaussian_filter(rng.uniform(0, 255, (h, w)), sigma)
    t = (t - t.min()) / (t.max() - t.min()) * 255.0
    return t.astype(F32)


def warped(img, theta, tx, ty):
    """img resampled so that a point (x, y) of img lands at R(theta) (x, y) +
    (tx, ty): the frame after a camera motion of that warp."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    c, s = np.cos(theta), np.sin(theta)
    # inverse map: the source of each destination pixel
    sx = c * (xs - tx) + s * (ys - ty)
    sy = -s * (xs - tx) + c * (ys - ty)
    sx, sy = np.clip(sx, 0, w - 1.001), np.clip(sy, 0, h - 1.001)
    x0, y0 = sx.astype(int), sy.astype(int)
    fx, fy = sx - x0, sy - y0
    out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
           + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return out.astype(F32)


@pytest.mark.parametrize("shape, out", [((1080, 1920), (162, 288)), ((720, 1280), (108, 192)),
                                         ((300, 400), (45, 60)), ((20, 30), (40, 50))])
def test_downscale_equals_jax_image_resize(shape, out):
    rng = np.random.default_rng(0)
    g = rng.uniform(0, 255, shape).astype(F32)
    want = np.asarray(jax.image.resize(jnp.asarray(g), out, method="linear"))
    got = tcmc.downscale(torch.from_numpy(g), out).numpy()
    assert got.shape == want.shape == out
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    img = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
    for bgr in (True, False):
        np.testing.assert_allclose(tcmc.to_gray(torch.from_numpy(img), bgr).numpy(),
                                   np.asarray(jcmc.to_gray(jnp.asarray(img), bgr)), rtol=1e-6,
                                   atol=1e-4)


@pytest.mark.parametrize("mode, motion", [("translation", (0.0, 1.3, -0.7)),
                                          ("euclidean", (0.012, -0.9, 0.6))])
def test_ecc_align_equals_jax(mode, motion):
    rng = np.random.default_rng(1)
    prev = textured(rng, 60, 80)
    curr = warped(prev, *motion)
    want = np.asarray(jcmc.ecc_align(jnp.asarray(prev), jnp.asarray(curr), 50, mode))
    got = tcmc.ecc_align(torch.from_numpy(prev), torch.from_numpy(curr), 50, mode).numpy()
    assert got.shape == (2, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    th, tx, ty = motion
    assert abs(got[0, 2] - tx) < 0.1 and abs(got[1, 2] - ty) < 0.1
    assert abs(np.arctan2(got[1, 0], got[0, 0]) - th) < 2e-3
    with pytest.raises(ValueError, match="mode"):
        tcmc.ecc_align(torch.from_numpy(prev), torch.from_numpy(curr), 2, "affine")


def test_ecc_apply_over_frames_equals_jax():
    """ECC on a frame sequence (BGR uint8 frames of a camera panning by known
    sub-pixel steps): the identity on the first frame, then each warp
    against the JAX ECC's, translations rescaled to full resolution."""
    rng = np.random.default_rng(2)
    scene = textured(rng, 260, 340, sigma=6.0)
    steps = [(0.0, 0.0, 0.0), (0.0, 2.4, -1.6), (0.0, -3.1, 0.8), (0.0, 1.7, 2.2)]
    frames, at = [], np.zeros(2)
    for _, tx, ty in steps:
        at += (tx, ty)
        g = warped(scene, 0.0, *at)
        frames.append(np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None], 3, axis=2))
    jecc, tecc = jcmc.ECC(scale=0.25), tcmc.create_cmc("ecc", device="cpu", scale=0.25)
    assert isinstance(tecc, tcmc.ECC) and tecc.device.type == "cpu"
    for i, f in enumerate(frames):
        want = jecc.apply(f)
        got = tecc.apply(f)
        assert torch.is_tensor(got) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-3)  # 1e-3 px at scale 0.25
        if i:
            np.testing.assert_allclose(got.numpy()[:, 2], steps[i][1:], atol=0.3)
        else:
            np.testing.assert_array_equal(got.numpy(), np.eye(2, 3))
    assert tecc.apply(None).numpy().tolist() == np.eye(2, 3).tolist()


def test_sof_numpy_path_equals_jax():
    """SOF without cv2 (forced off on both): the numpy pipeline's warps equal
    the JAX copy's, frame for frame."""
    rng = np.random.default_rng(3)
    scene = textured(rng, 400, 540, sigma=3.0)
    jsof, tsof = jcmc.SOF(), tcmc.SOF()
    jsof._has_cv2 = tsof._has_cv2 = False
    dets = np.array([[100, 100, 200, 300], [400, 50, 460, 150]], F32)
    at = np.zeros(2)
    moved = 0
    for f in range(4):
        at += rng.uniform(-4, 4, 2) if f else 0.0
        g = np.clip(warped(scene, 0.0, *at), 0, 255).astype(np.uint8)
        img = np.repeat(g[..., None], 3, axis=2)
        want, got = jsof.apply(img, dets), tsof.apply(img, dets)
        np.testing.assert_array_equal(got, want)
        moved += int(not np.array_equal(got, np.eye(2, 3)))
    assert moved >= 2  # the numpy pipeline found the motion


def test_registry_and_no_cmc():
    for name in ("ecc", "ORB", "sift", "sof", "none", " Ecc "):
        assert tcmc.get_cmc_method(name).__name__ == jcmc.get_cmc_method(name).__name__
    assert tcmc.get_cmc_method(None) is None and tcmc.create_cmc(None) is None
    with pytest.raises(ValueError, match="Unknown cmc_method"):
        tcmc.get_cmc_method("flow")
    np.testing.assert_array_equal(tcmc.create_cmc("none").apply(None), np.eye(2, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tcmc.create_cmc("ecc")  # ECC runs on the card unless the CPU is asked for

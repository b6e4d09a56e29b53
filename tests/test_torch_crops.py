"""The port's ReID crops (``ops/crops.py``: K5's plain twin, which the wrapper
runs on a CPU frame) against the JAX package's ``ops/crops.py``.

The same seeded uint8 frame and boxes go through both: the JAX functions on
the RGB frame (the JAX facade flips BGR before calling), the port's on the
BGR frame, whose crops are NCHW (JAX's NHWC transposed).  Boxes: random ones,
boxes past every edge, sub-pixel ones, the facade's unit padding boxes and,
rotated, angles of 0, +-pi/2 and +-pi.  Tolerances:

* before standardization 1e-6 (both compute the same two-tap sums; the JAX
  products add zeros, and XLA may contract a multiply-add), after it 5e-6
  (the division by the std scales by up to 4.5);
* rotated boxes with the angles' cos and sin taken from JAX as well, 1e-6;
  with the port's own (float64 rounded once, correctly rounded: JAX's float32
  cos or sin is one ulp off for some angles, which moves a sample by up to
  1 ulp of 1 times the box-local offset, under 1e-5 px here) 2e-5, and
  1e-4 after standardization.

The wrapper's CPU path is the twin's exactly, and it refuses what K5 does
not take.  The card's tests of K5 are in ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.ops import crops as jc
from boxmot_tpu_torch.ops import crops as tc

H, W = 72, 120
HW = (32, 16)


def _frame(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)


def _aabb(seed=1, n=10):
    rng = np.random.default_rng(seed)
    x1, y1 = rng.uniform(-20, W, n), rng.uniform(-20, H, n)
    b = np.stack([x1, y1, x1 + rng.uniform(0.4, 90, n), y1 + rng.uniform(0.4, 90, n)], 1)
    extra = [[0, 0, 1, 1],  # the facade's padding box
             [-40, -30, W + 25, H + 35],  # past every edge
             [W - 2, H - 3, W + 30, H + 20],  # past the far corner
             [-30, -25, 0.5, 0.25],  # past the near corner
             [10.3, 20.7, 10.6, 21.1],  # sub-pixel
             [5.0, 7.0, 5.0, 7.0]]  # zero size
    return np.concatenate([b, extra]).astype(np.float32)


def _obb(seed=2, n=10):
    rng = np.random.default_rng(seed)
    b = np.stack([rng.uniform(-10, W + 10, n), rng.uniform(-10, H + 10, n),
                  rng.uniform(0.4, 80, n), rng.uniform(0.4, 80, n),
                  rng.uniform(-np.pi, np.pi, n)], 1)
    extra = [[0, 0, 1, 1, 0],  # the facade's padding box
             [W / 2, H / 2, 2 * W, 2 * H, 0.3],  # past every edge
             [30, 20, 40, 60, np.pi / 2], [30, 20, 40, 60, -np.pi / 2],
             [50, 40, 25, 35, np.pi], [50, 40, 25, 35, -np.pi],
             [12.2, 9.7, 0.3, 0.4, 1.0]]  # sub-pixel
    return np.concatenate([b, extra]).astype(np.float32)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [HW, (7, 5)])
def test_aabb_crops_equal_jax(hw):
    img, boxes = _frame(), _aabb()
    rgb01 = jnp.asarray(img[..., ::-1]).astype(jnp.float32) / 255.0
    want = _nchw(jc.crop_resize_aabb(rgb01, jnp.asarray(boxes), hw))
    got = tc.crop_resize_aabb_plain(torch.from_numpy(img[..., ::-1].copy()),
                                    torch.from_numpy(boxes), hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want_std = _nchw(jc.extract_crops(jnp.asarray(img[..., ::-1]), jnp.asarray(boxes), hw))
    got_std = tc.extract_crops(torch.from_numpy(img), torch.from_numpy(boxes), hw).numpy()
    np.testing.assert_allclose(got_std, want_std, rtol=0, atol=5e-6)


@pytest.mark.parametrize("hw", [HW, (7, 5)])
def test_obb_crops_equal_jax(hw, monkeypatch):
    img, boxes = _frame(3), _obb()
    rgb01 = jnp.asarray(img[..., ::-1]).astype(jnp.float32) / 255.0
    want = _nchw(jc.crop_resize_obb(rgb01, jnp.asarray(boxes), hw))
    rgb = torch.from_numpy(img[..., ::-1].copy())
    with monkeypatch.context() as m:  # the angles' cos and sin as JAX's float32 ones
        jax_fn = {torch.cos: jnp.cos, torch.sin: jnp.sin}
        m.setattr(tc, "exact", lambda fn, x: torch.from_numpy(np.array(jax_fn[fn](x.numpy()))))
        got = tc.crop_resize_obb_plain(rgb, torch.from_numpy(boxes), hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = tc.crop_resize_obb_plain(rgb, torch.from_numpy(boxes), hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    want_std = _nchw(jc.extract_crops(jnp.asarray(img[..., ::-1]), jnp.asarray(boxes), hw,
                                      is_obb=True))
    got_std = tc.extract_crops(torch.from_numpy(img), torch.from_numpy(boxes), hw,
                               is_obb=True).numpy()
    np.testing.assert_allclose(got_std, want_std, rtol=0, atol=1e-4)


def test_standardize_equals_jax():
    crops = np.random.default_rng(4).uniform(0, 1, (3, 5, 4, 3)).astype(np.float32)
    want = _nchw(jc.standardize(jnp.asarray(crops)))
    got = tc.standardize(torch.from_numpy(crops.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("is_obb", [False, True], ids=["aabb", "obb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_wrapper_on_the_cpu_is_the_twin(is_obb, dtype):
    """The wrapper runs the twin on a CPU frame (no launch counted), and bf16
    is the fp32 result rounded to nearest."""
    img, boxes = torch.from_numpy(_frame(5)), torch.from_numpy(_obb() if is_obb else _aabb())
    before = tc.extract_crops.launches
    got = tc.extract_crops(img, boxes, HW, is_obb, dtype)
    assert tc.extract_crops.launches == before
    assert got.shape == (len(boxes), 3, *HW) and got.dtype == dtype
    want = tc.extract_crops_plain(img, boxes, HW, is_obb, torch.float32)
    assert torch.equal(got, want.to(dtype))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    img, boxes = torch.from_numpy(_frame()), torch.from_numpy(_aabb())
    with pytest.raises(ValueError, match="boxes"):
        tc.extract_crops(img, boxes[:, :3], HW)
    with pytest.raises(ValueError, match="boxes"):
        tc.extract_crops(img, boxes[:, :4], HW, is_obb=True)
    with pytest.raises(ValueError, match="float32"):
        tc.extract_crops(img, boxes.double(), HW)
    with pytest.raises(ValueError, match="uint8"):
        tc.extract_crops(img.float(), boxes, HW)
    with pytest.raises(ValueError, match="out_dtype"):
        tc.extract_crops(img, boxes, HW, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="uint8"):
        tc.as_frame(np.zeros((4, 4), np.uint8), "cpu")


# the behaviours of tests/test_reid.py:17-66, on the port's twin


def _float_img(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_identity_crop():
    img = np.random.default_rng(11).uniform(0, 1, (32, 16, 3)).astype(np.float32)
    out = tc.crop_resize_aabb_plain(_float_img(img), torch.tensor([[0.0, 0, 16, 32]]), (32, 16))
    np.testing.assert_allclose(out[0].permute(1, 2, 0).numpy(), img, atol=1e-5)


def test_constant_region():
    img = np.zeros((64, 64, 3), np.float32)
    img[10:30, 20:40] = 0.7
    out = tc.crop_resize_aabb_plain(_float_img(img), torch.tensor([[22.0, 12, 38, 28]]), (8, 8))
    np.testing.assert_allclose(out.numpy(), 0.7, atol=1e-5)


def test_downscale_average():
    img = np.zeros((2, 2, 1), np.float32)
    img[0, 0] = img[1, 1] = 1.0
    out = tc.crop_resize_aabb_plain(_float_img(img), torch.tensor([[0.0, 0, 2, 2]]), (1, 1))
    np.testing.assert_allclose(out[0, 0, 0, 0].item(), 0.5, atol=1e-5)


def test_obb_crop_axis_aligned_matches_aabb():
    img = _float_img(np.random.default_rng(12).uniform(0, 1, (64, 64, 3)))
    a = tc.crop_resize_aabb_plain(img, torch.tensor([[10.0, 20, 40, 50]]), (16, 16))
    o = tc.crop_resize_obb_plain(img, torch.tensor([[25.0, 35, 30, 30, 0.0]]), (16, 16))
    np.testing.assert_allclose(a.numpy(), o.numpy(), atol=1e-4)


def test_obb_rotation():
    img = np.zeros((64, 64, 1), np.float32)
    img[:, 30:34] = 1.0
    out = tc.crop_resize_obb_plain(_float_img(img), torch.tensor([[32.0, 32, 20, 20, np.pi / 2]]),
                                   (20, 20))
    assert out[0, 0].std(dim=1).mean().item() < 0.05  # the stripe spans rows


def test_extract_crops_standardized():
    img = np.full((32, 32, 3), 127, np.uint8)
    out = tc.extract_crops(torch.from_numpy(img), torch.tensor([[4.0, 4, 28, 28]]), (8, 8))
    expect = (127 / 255.0 - np.array(tc.IMAGENET_MEAN)) / np.array(tc.IMAGENET_STD)
    np.testing.assert_allclose(out[0, :, 0, 0].numpy(), expect, atol=1e-4)


def test_extract_crops_flips_bgr():
    """A blue frame (BGR) gives crops whose blue channel (RGB's third) is lit."""
    img = np.zeros((16, 16, 3), np.uint8)
    img[..., 0] = 255
    out = tc.extract_crops(torch.from_numpy(img), torch.tensor([[2.0, 2, 12, 12]]), (4, 4))
    lit = (1.0 - np.array(tc.IMAGENET_MEAN)) / np.array(tc.IMAGENET_STD)
    dark = -np.array(tc.IMAGENET_MEAN) / np.array(tc.IMAGENET_STD)
    np.testing.assert_allclose(out[0, :, 1, 1].numpy(), [dark[0], dark[1], lit[2]], atol=1e-5)

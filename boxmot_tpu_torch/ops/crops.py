"""ReID crops: kernel K5 and its plain twin.

Counterpart of ``boxmot_tpu/ops/crops.py`` (``crop_resize_aabb``,
``crop_resize_obb``, ``standardize``, ``extract_crops``).  The JAX package
resamples axis-aligned crops as two dense fp32 products over (N, oh, H) and
(N, ow, W) interpolation matrices, because gathers are slow on the TPU; on
this card a gather is natural, so ``extract_crops`` on a CUDA frame launches
``csrc/crops.cu`` once: a block a crop's band of rows shares the rows' and
columns' taps and a table of k / 255, a thread two output columns reads
their taps of the uint8 BGR frame, flips them to RGB, interpolates and
standardizes, and writes the (N, 3, oh, ow) input of the backbone.  On a CPU
frame it runs ``extract_crops_plain``, the same arithmetic in plain PyTorch.

The sampling is JAX's, per axis: output pixel (i, j) of an axis-aligned box
samples ``g = (i + 0.5) * (y2 - y1) / oh + (y1 - 0.5)`` (cv2.resize's
centre mapping), clamped to [0, size - 1], between ``floor(g)`` and
``min(floor(g) + 1, size - 1)`` (so the border replicates); a rotated box
(cx, cy, w, h, a) maps (i, j) to box-local ``u = ((j + 0.5) / ow - 0.5) * w``,
``v = ((i + 0.5) / oh - 0.5) * h`` and samples ``x = cx + u cos a - v sin a -
0.5``, ``y = cy + u sin a + v cos a - 0.5``.  The twin gathers the four taps
and never forms the dense matrices (they are mostly zeros; the JAX products
add those zeros, which changes no bit of the sum of the two nonzero terms).

Bits: the twin and the kernel do the same float32 operations in the same
order, every division a true division (on the card PyTorch multiplies by the
reciprocal of a Python scalar, so the twin divides by tensors), and the
angles' cos and sin come from ``geometry.exact`` in the wrapper, so the
kernel equals its twin bit for bit.  With ``out_dtype=torch.bfloat16`` both
round the float32 value to nearest, as ``.to(torch.bfloat16)`` does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.ops.geometry import exact

# copied from boxmot_tpu/ops/crops.py:21-22
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # -> the kernel's output tag
MAX_CROPS = 65535  # K5's grid has a block row per crop on its z axis
_P = ctypes.c_void_p
_I = ctypes.c_int


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a (1,) float32 tensor on ``like``'s device: a divisor that
    PyTorch divides by, never turning it into a product with its reciprocal."""
    return torch.full((1,), value, dtype=torch.float32, device=like.device)


def _axis(g: torch.Tensor, size: int):
    """Clamped-bilinear taps of coordinates ``g`` on an axis of ``size``
    pixels: (c0, c1) as int64 and the weight of c1 (``_interp_matrix``'s
    per-axis math, boxmot_tpu/ops/crops.py:51-68)."""
    c = torch.clamp(g, 0.0, size - 1.0)
    c0 = torch.floor(c)
    c1 = torch.clamp_max(c0 + 1.0, size - 1.0)
    return c0.long(), c1.long(), c - c0


def _sample(img: torch.Tensor, y, x) -> torch.Tensor:
    """``img`` (H, W, C) sampled at the taps ``y``, ``x`` ((c0, c1, w) each,
    broadcast against each other) -> (..., C) float32: the horizontal pair
    first, then the vertical, as ``_bilinear_sample`` (crops.py:25-48).  A
    uint8 image's taps are divided by 255 before they are weighted."""
    (y0, y1, wy), (x0, x1, wx) = y, x
    taps = [img[a, b] for a, b in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    if img.dtype == torch.uint8:
        d = _scalar(255.0, img)
        taps = [t.to(torch.float32) / d for t in taps]
    v00, v01, v10, v11 = taps
    wx, wy = wx[..., None], wy[..., None]
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def crop_resize_aabb_plain(img: torch.Tensor, xyxy: torch.Tensor,
                           out_hw=(256, 128)) -> torch.Tensor:
    """Crops of axis-aligned boxes: ``img`` (H, W, C) float (or uint8, read as
    value / 255), ``xyxy`` (N, 4) -> (N, C, oh, ow) float32."""
    oh, ow = out_hw
    H, W = img.shape[0], img.shape[1]
    x1, y1, x2, y2 = (xyxy[:, k] for k in range(4))
    sy = (y2 - y1) / _scalar(oh, xyxy)
    sx = (x2 - x1) / _scalar(ow, xyxy)
    i = torch.arange(oh, dtype=torch.float32, device=xyxy.device) + 0.5
    j = torch.arange(ow, dtype=torch.float32, device=xyxy.device) + 0.5
    gy = i[None, :] * sy[:, None] + (y1[:, None] - 0.5)  # (N, oh)
    gx = j[None, :] * sx[:, None] + (x1[:, None] - 0.5)  # (N, ow)
    y = tuple(t[:, :, None] for t in _axis(gy, H))
    x = tuple(t[:, None, :] for t in _axis(gx, W))
    return _sample(img, y, x).permute(0, 3, 1, 2)


def crop_resize_obb_plain(img: torch.Tensor, xywha: torch.Tensor,
                          out_hw=(256, 128)) -> torch.Tensor:
    """Rectified crops of rotated boxes (cx, cy, w, h, angle): (N, C, oh, ow)
    float32."""
    oh, ow = out_hw
    H, W = img.shape[0], img.shape[1]
    cx, cy, w, h, a = (xywha[:, k] for k in range(5))
    ca, sa = exact(torch.cos, a), exact(torch.sin, a)
    dev = xywha.device
    ub = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / _scalar(ow, xywha) - 0.5
    vb = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / _scalar(oh, xywha) - 0.5
    u = ub[None, None, :] * w[:, None, None]  # (N, 1, ow)
    v = vb[None, :, None] * h[:, None, None]  # (N, oh, 1)
    c3 = lambda t: t[:, None, None]  # noqa: E731
    xs = c3(cx) + u * c3(ca) - v * c3(sa) - 0.5
    ys = c3(cy) + u * c3(sa) + v * c3(ca) - 0.5
    return _sample(img, _axis(ys, H), _axis(xs, W)).permute(0, 3, 1, 2)


def standardize(crops_rgb01: torch.Tensor) -> torch.Tensor:
    """ImageNet standardization of (N, 3, H, W) RGB crops in [0, 1]."""
    shape = (1, 3, 1, 1)
    mean = torch.tensor(IMAGENET_MEAN, dtype=crops_rgb01.dtype).reshape(shape)
    std = torch.tensor(IMAGENET_STD, dtype=crops_rgb01.dtype).reshape(shape)
    return (crops_rgb01 - mean.to(crops_rgb01.device)) / std.to(crops_rgb01.device)


def extract_crops_plain(img_bgr_u8: torch.Tensor, boxes: torch.Tensor, out_hw=(256, 128),
                        is_obb: bool = False, out_dtype=torch.float32) -> torch.Tensor:
    """The twin of K5: a uint8 BGR frame (H, W, 3) and (N, 4) xyxy or (N, >= 5)
    xywha boxes -> standardized RGB crops (N, 3, oh, ow) of ``out_dtype``."""
    rgb = img_bgr_u8.flip(-1)
    if is_obb:
        crops = crop_resize_obb_plain(rgb, boxes[:, :5], out_hw)
    else:
        crops = crop_resize_aabb_plain(rgb, boxes[:, :4], out_hw)
    return standardize(crops).to(out_dtype)


def as_frame(img, device) -> torch.Tensor:
    """A uint8 (H, W, 3) frame on ``device``: a host array is uploaded once,
    as uint8; a tensor is moved if it is elsewhere."""
    t = img if torch.is_tensor(img) else torch.from_numpy(np.ascontiguousarray(img))
    if t.dtype != torch.uint8 or t.dim() != 3 or t.shape[2] != 3:
        raise ValueError(f"extract_crops: the frame must be (H, W, 3) uint8, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t.to(device).contiguous()


def extract_crops(img_bgr_u8: torch.Tensor, boxes: torch.Tensor, out_hw=(256, 128),
                  is_obb: bool = False, out_dtype=torch.float32) -> torch.Tensor:
    """Standardized RGB crops (N, 3, oh, ow), as ``extract_crops_plain``;
    kernel K5 (one launch) when the frame lies on the card."""
    cols = 5 if is_obb else 4
    if boxes.dim() != 2 or boxes.shape[1] < cols:
        raise ValueError(f"extract_crops: boxes must be (N, >= {cols}), got {tuple(boxes.shape)}")
    if boxes.dtype != torch.float32 or boxes.device != img_bgr_u8.device:
        raise ValueError("extract_crops: boxes must be float32 on the frame's device")
    if img_bgr_u8.dtype != torch.uint8 or img_bgr_u8.dim() != 3 or img_bgr_u8.shape[2] != 3:
        raise ValueError("extract_crops: the frame must be (H, W, 3) uint8")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"extract_crops: out_dtype must be float32 or bfloat16, got {out_dtype}")
    dev = img_bgr_u8.device
    if dev.type == "cpu":
        return extract_crops_plain(img_bgr_u8, boxes, out_hw, is_obb, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"extract_crops: unsupported device {dev}")
    oh, ow = out_hw
    N, (H, W) = boxes.shape[0], img_bgr_u8.shape[:2]
    if N > MAX_CROPS:
        raise ValueError(f"extract_crops: at most {MAX_CROPS} boxes a launch, got {N}")
    out = torch.empty((N, 3, oh, ow), dtype=out_dtype, device=dev)
    if N == 0:
        return out
    box = boxes[:, :cols].contiguous()
    trig = None
    if is_obb:  # float64 and rounded once: the twin's bits on every device
        trig = torch.stack([exact(torch.cos, box[:, 4]), exact(torch.sin, box[:, 4])]).contiguous()
    launch_crops(img_bgr_u8.contiguous(), box, trig, out)
    return out


def launch_crops(frame: torch.Tensor, box: torch.Tensor, trig: torch.Tensor | None,
                 out: torch.Tensor) -> None:
    """One launch of K5 into ``out`` (N, 3, oh, ow), contiguous, aligned or not
    (``extract_crops`` allocates it; a test hands the kernel an unaligned
    view here): ``frame`` (H, W, 3) uint8, ``box`` (N, 4) or, with ``trig``
    (2, N), (N, 5), contiguous on the card."""
    (N, _, oh, ow), (H, W) = out.shape, frame.shape[:2]
    dev = frame.device
    cols = 4 if trig is None else 5
    tensors = (frame, box, out) if trig is None else (frame, box, out, trig)
    if (dev.type != "cuda" or any(x.device != dev or not x.is_contiguous() for x in tensors)
            or frame.dtype != torch.uint8 or frame.dim() != 3 or frame.shape[2] != 3
            or box.dtype != torch.float32 or tuple(box.shape) != (N, cols)
            or out.dim() != 4 or out.shape[1] != 3 or out.dtype not in OUT_DTYPES
            or (trig is not None and (trig.dtype != torch.float32 or tuple(trig.shape) != (2, N)))):
        raise ValueError("launch_crops: a contiguous (H, W, 3) uint8 frame, (N, 4) float32 "
                         "boxes (or (N, 5) with (2, N) float32 trig) and an (N, 3, oh, ow) "
                         "float32 or bfloat16 out, all on one card")
    fn = build.entry("crops", "bmt_crops", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        rc = fn(frame.data_ptr(), box.data_ptr(), None if trig is None else trig.data_ptr(),
                out.data_ptr(), H, W, N, oh, ow, int(trig is not None), OUT_DTYPES[out.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("crops", "bmt_crops", rc)
    extract_crops.launches += 1


extract_crops.launches = 0

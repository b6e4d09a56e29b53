"""Camera-motion compensation (counterpart of boxmot_tpu/motion/cmc.py).

ECC runs on the device in plain PyTorch: grayscale conversion, the
antialiased linear downscale of ``jax.image.resize`` (a triangle filter
written out as two weight matrices), and ``ecc_align``, a fixed 50
Gauss-Newton iterations on the Enhanced Correlation Coefficient criterion
(Evangelidis & Psarakis, PAMI 2008) in translation or euclidean mode.  The
trip count is static and the small normal equations are inverted in closed
form, so an ``apply`` reads nothing back to the host: ``ECC`` keeps the
previous frame on the device and returns the (2, 3) warp as a device
tensor, which the tracker step takes as it is.

ORB, SIFT and SOF are host code, copied from the JAX module with its
numpy sparse-optical-flow machinery: they use OpenCV when it is installed
(ORB and SIFT need it; SOF falls back to the numpy pipeline without it, as
the original chooses) and return (2, 3) float32 numpy warps.

Conventions are the reference's: a warp maps previous-frame coordinates to
current-frame coordinates, and a translation estimated on a downscaled
image is rescaled to full resolution.
"""

from __future__ import annotations

import numpy as np
import torch

BGR_GRAY = (0.114, 0.587, 0.299)  # cv2 BGR2GRAY weights


def to_gray(img: torch.Tensor, bgr: bool = True) -> torch.Tensor:
    """(H, W, 3) image -> (H, W) float32 luminance."""
    w = BGR_GRAY if bgr else BGR_GRAY[::-1]
    x = img.to(torch.float32)
    return x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., "linear")`` along one
    axis (``compute_weight_mat`` with antialiasing): a triangle filter
    widened by 1 / scale when downsampling, each column normalised to sum 1,
    in float32 as JAX forms it."""
    f32 = torch.float32
    scale = torch.full((), n_out / n_in, dtype=f32, device=device)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None])
    weights = torch.clamp_min(1.0 - x / kernel_scale, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def downscale(gray: torch.Tensor, out_hw) -> torch.Tensor:
    """(H, W) -> out_hw, as ``jax.image.resize(gray, out_hw, "linear")``:
    each output pixel a triangle-weighted mean of the inputs under it."""
    H, W = gray.shape
    oh, ow = out_hw
    out = gray
    if oh != H:
        out = _resize_weights(H, oh, gray.device).T @ out
    if ow != W:
        out = out @ _resize_weights(W, ow, gray.device)
    return out


def _sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (..., H, W) at (ys, xs), clamped inside the
    image: each leading channel sampled as the JAX ``_sample`` samples one
    image, the indices and weights formed once for all of them."""
    H, W = img.shape[-2:]
    ys = torch.clamp(ys, 0.0, H - 1.001)
    xs = torch.clamp(xs, 0.0, W - 1.001)
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0f, xs - x0f
    i00 = y0f.long() * W + x0f.long()
    flat = img.reshape(img.shape[:-2] + (H * W,))
    v00 = flat[..., i00]
    v01 = flat[..., i00 + 1]
    v10 = flat[..., i00 + W]
    v11 = flat[..., i00 + W + 1]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def _inv_small(C: torch.Tensor) -> torch.Tensor:
    """Inverse of a 2 x 2 or 3 x 3 matrix by its adjugate: no host read, where
    ``torch.linalg.inv`` checks its result on the host."""
    if C.shape[0] == 2:
        a, b, c, d = C[0, 0], C[0, 1], C[1, 0], C[1, 1]
        det = a * d - b * c
        return torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) / det
    m = [[C[i, j] for j in range(3)] for i in range(3)]

    def cof(i, j):
        r = [k for k in range(3) if k != i]
        c = [k for k in range(3) if k != j]
        return m[r[0]][c[0]] * m[r[1]][c[1]] - m[r[0]][c[1]] * m[r[1]][c[0]]

    det = m[0][0] * cof(0, 0) - m[0][1] * cof(0, 1) + m[0][2] * cof(0, 2)
    adj = torch.stack([torch.stack([cof(j, i) * (1.0 if (i + j) % 2 == 0 else -1.0)
                                    for j in range(3)]) for i in range(3)])
    return adj / det


def ecc_align(prev: torch.Tensor, curr: torch.Tensor, n_iters: int = 50,
              mode: str = "translation") -> torch.Tensor:
    """Estimate the warp aligning prev -> curr, equal-shape grayscale images
    on one device, as the JAX ``ecc_align``.  Returns a (2, 3) float32 affine
    matrix on that device.

    mode: "translation" (2 parameters, the reference default) or
    "euclidean" (rotation + translation).
    """
    if mode not in ("translation", "euclidean"):
        raise ValueError(f"ecc_align: unknown mode {mode!r}")
    dev = prev.device
    H, W = prev.shape
    f32 = torch.float32
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                            torch.arange(W, dtype=f32, device=dev), indexing="ij")
    tpl = prev.to(f32)
    t = (tpl - tpl.mean()).reshape(-1)

    # gradients of the current image (central differences, zero border)
    cf = curr.to(f32)
    gx = torch.zeros_like(cf)
    gx[:, 1:-1] = (cf[:, 2:] - cf[:, :-2]) / 2.0
    gy = torch.zeros_like(cf)
    gy[1:-1, :] = (cf[2:, :] - cf[:-2, :]) / 2.0
    images = torch.stack([cf, gx, gy])  # sampled together at each warp

    n_params = 2 if mode == "translation" else 3
    eye = torch.eye(n_params, dtype=f32, device=dev) * 1e-6
    p = torch.zeros((n_params,), dtype=f32, device=dev)
    for _ in range(n_iters):
        if mode == "translation":
            wys, wxs = ys + p[1], xs + p[0]
        else:
            c, s = torch.cos(p[0]), torch.sin(p[0])
            wxs = c * xs - s * ys + p[1]
            wys = s * xs + c * ys + p[2]
        iw, gxw, gyw = _sample(images, wys, wxs).unbind(0)
        if mode == "translation":
            J = torch.stack([gxw.reshape(-1), gyw.reshape(-1)], dim=1)  # (N, 2)
        else:
            j_th = gxw * (-s * xs - c * ys) + gyw * (c * xs - s * ys)
            J = torch.stack([j_th.reshape(-1), gxw.reshape(-1), gyw.reshape(-1)], dim=1)
        iw_zm = (iw - iw.mean()).reshape(-1)
        Cinv = _inv_small(J.T @ J + eye)
        Gi, Gt = (J.T @ torch.stack([iw_zm, t], dim=1)).unbind(1)
        ii, ti = (torch.stack([iw_zm, t]) @ iw_zm).unbind(0)
        CGi = Cinv @ Gi
        num = ii - Gi @ CGi
        den = ti - Gt @ CGi
        lam = num / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
        # J^T (lam t - iw_zm) = lam Gt - Gi: no second pass over the pixels
        p = p + Cinv @ (lam * Gt - Gi)

    if mode == "translation":
        one, zero = torch.ones((), dtype=f32, device=dev), torch.zeros((), dtype=f32, device=dev)
        return torch.stack([torch.stack([one, zero, p[0]]), torch.stack([zero, one, p[1]])])
    c, s = torch.cos(p[0]), torch.sin(p[0])
    return torch.stack([torch.stack([c, -s, p[1]]), torch.stack([s, c, p[2]])])


class ECC:
    """Stateful ECC on ``device`` (the reference ECC class's surface,
    motion/cmc/ecc.py:14-100): keeps the previous downscaled grayscale frame
    on the device and returns each new frame's (2, 3) warp as a float32
    device tensor (the identity for the first frame or a size change)."""

    def __init__(self, warp_mode: str = "translation", max_iter: int = 50, scale: float = 0.15,
                 grayscale: bool = True, bgr: bool = True, device="cuda"):
        from boxmot_tpu_torch.utils.device import resolve_device

        self.mode = warp_mode
        self.max_iter = max_iter
        self.scale = scale
        self.bgr = bgr
        self.device = resolve_device(device)
        self.prev = None

    def preprocess(self, img) -> torch.Tensor:
        # a frame decoded as a BGR view of RGB has negative strides
        x = img.to(self.device) if torch.is_tensor(img) else torch.from_numpy(
            np.ascontiguousarray(img)).to(self.device)
        g = to_gray(x, bgr=self.bgr) if x.dim() == 3 else x.to(torch.float32)
        if self.scale < 1.0:
            hw = (max(int(g.shape[0] * self.scale), 8), max(int(g.shape[1] * self.scale), 8))
            g = downscale(g, hw)
        return g

    def apply(self, img, dets=None) -> torch.Tensor:
        warp = torch.eye(2, 3, dtype=torch.float32, device=self.device)
        if img is None:
            return warp
        curr = self.preprocess(img)
        if self.prev is None or self.prev.shape != curr.shape:
            self.prev = curr
            return warp
        w = ecc_align(self.prev, curr, self.max_iter, self.mode)
        self.prev = curr
        if self.scale < 1.0:
            # divide by a float32 tensor: a CUDA division by a Python scalar
            # would multiply by its reciprocal
            s = torch.full((), self.scale, dtype=torch.float32, device=self.device)
            w = torch.cat([w[:, :2], (w[:, 2] / s)[:, None]], dim=1)
        return w


class NoCMC:
    def apply(self, img, dets=None):
        return np.eye(2, 3, dtype=np.float32)


class _FeatureCMC:
    """Shared host-side machinery of the keypoint CMC estimators (copy of the
    JAX module's ``_FeatureCMC``, reference base_cmc.py:31-105): BGR->gray and
    downscale, a border + detection mask, and translation upscaling."""

    scale: float = 0.15

    def _preprocess(self, img):
        import cv2

        out = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
        if self.scale and self.scale != 1.0:
            out = cv2.resize(
                out, (0, 0), fx=self.scale, fy=self.scale,
                interpolation=cv2.INTER_LINEAR,
            )
        return out

    def _mask(self, img_gray, dets):
        h, w = img_gray.shape[:2]
        mask = np.zeros((h, w), np.uint8)
        mask[int(0.02 * h) : int(0.98 * h), int(0.02 * w) : int(0.98 * w)] = 255
        if dets is None or np.asarray(dets).size == 0:
            return mask
        for det in np.asarray(dets):
            if len(det) < 4:
                continue
            x1, y1, x2, y2 = (np.asarray(det[:4], np.float32) * self.scale).astype(int)
            x1, x2 = max(0, min(w, x1)), max(0, min(w, x2))
            y1, y2 = max(0, min(h, y1)), max(0, min(h, y2))
            if x2 > x1 and y2 > y1:
                mask[y1:y2, x1:x2] = 0
        return mask

    def _upscale(self, H):
        if self.scale < 1.0:
            H = H.copy()
            H[0, 2] /= self.scale
            H[1, 2] /= self.scale
        return H.astype(np.float32)


class _DescriptorCMC(_FeatureCMC):
    """ORB/SIFT common flow (copy; reference orb.py:46-147, sift.py): detect
    and describe, KNN match with Lowe ratio 0.9, spatial gating at 25 % of
    the frame, 2.5-sigma outlier rejection, RANSAC partial-affine fit."""

    def __init__(self, scale: float = 0.15):
        self.scale = float(scale)
        self.prev_img = None
        self.prev_keypoints = None
        self.prev_descriptors = None

    def _store(self, img_p, keypoints, descriptors):
        self.prev_img = img_p.copy()
        self.prev_keypoints = keypoints
        self.prev_descriptors = descriptors

    def apply(self, img, dets=None):
        import cv2

        H = np.eye(2, 3, dtype=np.float32)
        img_p = self._preprocess(np.asarray(img))
        h, w = img_p.shape[:2]
        mask = self._mask(img_p, dets)

        keypoints = self.detector.detect(img_p, mask)
        keypoints, descriptors = self.extractor.compute(img_p, keypoints)
        if descriptors is None or len(keypoints) < 4 or self.prev_descriptors is None:
            self._store(img_p, keypoints, descriptors)
            return H

        knn = self.matcher.knnMatch(self.prev_descriptors, descriptors, k=2)
        matches, dxys = [], []
        max_sd = 0.25 * np.array([w, h], np.float32)
        for pair in knn:
            if len(pair) != 2:
                continue
            m, n = pair
            if m.distance >= 0.9 * n.distance:
                continue
            prev_pt = np.array(self.prev_keypoints[m.queryIdx].pt, np.float32)
            curr_pt = np.array(keypoints[m.trainIdx].pt, np.float32)
            dxy = prev_pt - curr_pt
            if abs(dxy[0]) < max_sd[0] and abs(dxy[1]) < max_sd[1]:
                matches.append(m)
                dxys.append(dxy)
        if len(matches) < 4:
            self._store(img_p, keypoints, descriptors)
            return H

        dxys = np.asarray(dxys, np.float32)
        ok = np.all((dxys - dxys.mean(axis=0)) < 2.5 * (dxys.std(axis=0) + 1e-6), axis=1)
        good = [m for m, k in zip(matches, ok) if k]
        if len(good) < 4:
            self._store(img_p, keypoints, descriptors)
            return H

        prev_pts = np.array([self.prev_keypoints[m.queryIdx].pt for m in good], np.float32)
        curr_pts = np.array([keypoints[m.trainIdx].pt for m in good], np.float32)
        H_est, _ = cv2.estimateAffinePartial2D(prev_pts, curr_pts, method=cv2.RANSAC)
        self._store(img_p, keypoints, descriptors)
        if H_est is None:
            return H
        return self._upscale(H_est)


class ORB(_DescriptorCMC):
    """FAST keypoints + ORB descriptors + Hamming BFMatcher (copy; reference
    orb.py:14-44).  Needs cv2."""

    def __init__(self, feature_detector_threshold: int = 20, scale: float = 0.15, **kw):
        import cv2

        super().__init__(scale=scale)
        self.detector = cv2.FastFeatureDetector_create(
            threshold=int(feature_detector_threshold)
        )
        self.extractor = cv2.ORB_create()
        self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING)


class SIFT(_DescriptorCMC):
    """SIFT keypoints/descriptors + L2 BFMatcher (copy; reference
    sift.py:27-40).  Needs cv2.  The reference's contrastThreshold=0.5 finds
    no keypoints on typical MOT footage at 0.15 scale, so this usually
    returns the identity, as there; pass contrast_threshold=0.04 for a
    working SIFT CMC."""

    def __init__(self, scale: float = 0.15, contrast_threshold: float = 0.5, **kw):
        import cv2

        super().__init__(scale=scale)
        sift = lambda: cv2.SIFT_create(  # noqa: E731
            nOctaveLayers=2, contrastThreshold=contrast_threshold, edgeThreshold=10
        )
        self.detector = sift()
        self.extractor = sift()
        self.matcher = cv2.BFMatcher(cv2.NORM_L2)


class SOF(_FeatureCMC):
    """Sparse optical flow: goodFeaturesToTrack + pyramidal LK + RANSAC
    partial affine, with inlier-count/ratio rejection (copy; reference
    sof.py:14-147).  OpenCV when it is installed, else the numpy pipeline
    (``_np_shi_tomasi``, ``_np_pyr_lk``, ``_np_similarity_ransac``) with the
    same stages and gates."""

    def __init__(
        self,
        scale: float = 0.15,
        min_inliers: int = 8,
        min_inlier_ratio: float = 0.2,
        ransac_reproj_threshold: float = 3.0,
        **kw,
    ):
        import importlib.util

        self._has_cv2 = importlib.util.find_spec("cv2") is not None
        self.scale = float(scale)
        self.min_inliers = int(min_inliers)
        self.min_inlier_ratio = float(min_inlier_ratio)
        self.ransac_reproj_threshold = float(ransac_reproj_threshold)
        self.feature_params = dict(
            maxCorners=1000, qualityLevel=0.01, minDistance=1, blockSize=3,
            useHarrisDetector=False, k=0.04,
        )
        if self._has_cv2:
            import cv2

            self.lk_params = dict(
                winSize=(21, 21), maxLevel=3,
                criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01),
            )
        self.prev_frame = None
        self.prev_keypoints = None
        self.initialized = False

    def _detect(self, frame_gray, dets):
        import cv2

        return cv2.goodFeaturesToTrack(
            frame_gray, mask=self._mask(frame_gray, dets), **self.feature_params
        )

    def _reset(self, frame_gray, dets=None):
        kps = self._detect(frame_gray, dets)
        self.prev_frame = frame_gray.copy()
        self.prev_keypoints = kps
        self.initialized = kps is not None and len(kps) >= 4

    def apply(self, img, dets=None):
        if not self._has_cv2:
            return self._apply_np(img, dets)
        import cv2

        frame_gray = self._preprocess(np.asarray(img))
        H = np.eye(2, 3, dtype=np.float32)

        if not self.initialized or self.prev_keypoints is None:
            kps = self._detect(frame_gray, dets)
            if kps is None or len(kps) < 4:
                self.prev_frame = frame_gray.copy()
                self.prev_keypoints = kps
                self.initialized = False
                return H
            term = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01)
            cv2.cornerSubPix(frame_gray, kps, (5, 5), (-1, -1), term)
            self.prev_frame = frame_gray.copy()
            self.prev_keypoints = kps.copy()
            self.initialized = True
            return H

        next_kps, status, _ = cv2.calcOpticalFlowPyrLK(
            self.prev_frame, frame_gray, self.prev_keypoints, None, **self.lk_params
        )
        if next_kps is None or status is None:
            self._reset(frame_gray, dets)
            return H
        status = status.reshape(-1)
        prev_valid = self.prev_keypoints[status == 1]
        next_valid = next_kps[status == 1]
        if len(prev_valid) < 4:
            self._reset(frame_gray, dets)
            return H

        H_est, inliers = cv2.estimateAffinePartial2D(
            prev_valid, next_valid, method=cv2.RANSAC,
            ransacReprojThreshold=self.ransac_reproj_threshold,
        )
        n_in = 0 if inliers is None else int(np.count_nonzero(inliers))
        if (
            H_est is None
            or n_in < self.min_inliers
            or n_in / max(len(prev_valid), 1) < self.min_inlier_ratio
        ):
            H_est = H
        else:
            H_est = self._upscale(H_est)

        new_kps = self._detect(frame_gray, dets)
        if new_kps is None or len(new_kps) < 4:
            new_kps = next_valid
        self.prev_frame = frame_gray.copy()
        self.prev_keypoints = new_kps.copy()
        self.initialized = True
        return H_est

    # -- cv2-free path --------------------------------------------------

    def _detect_np(self, frame_gray, dets):
        fp = self.feature_params
        return _np_shi_tomasi(
            frame_gray,
            mask=self._mask(frame_gray, dets),
            max_corners=fp["maxCorners"],
            quality=fp["qualityLevel"],
            min_distance=fp["minDistance"],
            block=fp["blockSize"],
        )

    def _apply_np(self, img, dets=None):
        frame_gray = _np_gray(img, self.scale)
        H = np.eye(2, 3, dtype=np.float32)

        if not self.initialized or self.prev_keypoints is None or len(self.prev_keypoints) < 4:
            kps = self._detect_np(frame_gray, dets)
            self.prev_frame = frame_gray
            self.prev_keypoints = kps
            self.initialized = len(kps) >= 4
            return H

        next_kps, status = _np_pyr_lk(self.prev_frame, frame_gray, self.prev_keypoints)
        prev_valid = self.prev_keypoints[status]
        next_valid = next_kps[status]
        if len(prev_valid) < 4:
            kps = self._detect_np(frame_gray, dets)
            self.prev_frame = frame_gray
            self.prev_keypoints = kps
            self.initialized = len(kps) >= 4
            return H

        H_est, inliers = _np_similarity_ransac(
            prev_valid, next_valid, thresh=self.ransac_reproj_threshold
        )
        n_in = int(np.count_nonzero(inliers))
        if (
            H_est is None
            or n_in < self.min_inliers
            or n_in / max(len(prev_valid), 1) < self.min_inlier_ratio
        ):
            H_est = H
        else:
            H_est = self._upscale(H_est)

        new_kps = self._detect_np(frame_gray, dets)
        if len(new_kps) < 4:
            new_kps = next_valid
        self.prev_frame = frame_gray
        self.prev_keypoints = new_kps
        self.initialized = True
        return H_est


# ---------------------------------------------------------------------------
# cv2-free sparse-optical-flow machinery (copy of the JAX module's): SOF
# uses it when OpenCV is not installed.  Shi-Tomasi corners + pyramidal
# Lucas-Kanade + RANSAC similarity fit.
# ---------------------------------------------------------------------------


def _np_gray(img, scale):
    """BGR (or gray) image -> float32 grayscale, bilinearly downscaled
    with cv2-style half-pixel centers."""
    img = np.asarray(img)
    g = (
        img.astype(np.float32) @ np.asarray(BGR_GRAY, np.float32)
        if img.ndim == 3
        else img.astype(np.float32)
    )
    if not scale or scale == 1.0:
        return g
    H, W = g.shape
    oh, ow = max(int(H * scale), 8), max(int(W * scale), 8)
    ys = np.clip((np.arange(oh) + 0.5) * (H / oh) - 0.5, 0, H - 1.001)
    xs = np.clip((np.arange(ow) + 0.5) * (W / ow) - 0.5, 0, W - 1.001)
    y0 = ys.astype(np.int32)
    x0 = xs.astype(np.int32)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    return (
        g[y0][:, x0] * (1 - wy) * (1 - wx)
        + g[y0][:, x0 + 1] * (1 - wy) * wx
        + g[y0 + 1][:, x0] * wy * (1 - wx)
        + g[y0 + 1][:, x0 + 1] * wy * wx
    )


def _np_shi_tomasi(gray, mask=None, max_corners=1000, quality=0.01, min_distance=1,
                   block=3):
    """goodFeaturesToTrack equivalent: min-eigenvalue corner response,
    quality-relative threshold, distance-based non-max suppression."""
    from scipy.ndimage import maximum_filter, uniform_filter

    Iy, Ix = np.gradient(gray.astype(np.float32))
    xx = uniform_filter(Ix * Ix, block)
    yy = uniform_filter(Iy * Iy, block)
    xy = uniform_filter(Ix * Iy, block)
    # min eigenvalue of the structure tensor
    tr = xx + yy
    det = np.sqrt(np.maximum((xx - yy) ** 2 + 4 * xy**2, 0.0))
    r = (tr - det) / 2.0
    if mask is not None:
        r = np.where(mask > 0, r, 0.0)
    peak = r.max()
    if peak <= 0:
        return np.empty((0, 2), np.float32)
    size = 2 * max(int(min_distance), 1) + 1
    is_peak = (r == maximum_filter(r, size=size)) & (r >= quality * peak)
    ys, xs = np.nonzero(is_peak)
    order = np.argsort(r[ys, xs])[::-1][:max_corners]
    return np.stack([xs[order], ys[order]], axis=-1).astype(np.float32)


def _np_pyramid(gray, levels):
    pyr = [gray.astype(np.float32)]
    for _ in range(levels):
        g = pyr[-1]
        h2, w2 = g.shape[0] // 2, g.shape[1] // 2
        if h2 < 8 or w2 < 8:
            break
        pyr.append(g[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(axis=(1, 3)))
    return pyr


def _np_sample_patches(img, cx, cy, half):
    """Bilinear (2*half+1)^2 patches around each (cx, cy) with border
    clamp, batched: cx/cy (N,) -> (N, win, win)."""
    H, W = img.shape
    offs = np.arange(-half, half + 1, dtype=np.float32)
    ys = np.clip(cy[:, None] + offs[None, :], 0, H - 1.001)  # (N, win)
    xs = np.clip(cx[:, None] + offs[None, :], 0, W - 1.001)
    y0 = ys.astype(np.int32)[:, :, None]  # (N, win, 1)
    x0 = xs.astype(np.int32)[:, None, :]  # (N, 1, win)
    wy = (ys - y0[..., 0])[:, :, None]
    wx = (xs - x0[:, 0, :])[:, None, :]
    return (
        img[y0, x0] * (1 - wy) * (1 - wx)
        + img[y0, x0 + 1] * (1 - wy) * wx
        + img[y0 + 1, x0] * wy * (1 - wx)
        + img[y0 + 1, x0 + 1] * wy * wx
    )


def _np_pyr_lk(prev, curr, pts, win=21, levels=3, iters=30, eps=0.01):
    """calcOpticalFlowPyrLK equivalent, vectorized over points.
    pts: (N, 2) xy.  Returns (next_pts, status)."""
    half = win // 2
    prev_pyr = _np_pyramid(prev, levels)
    curr_pyr = _np_pyramid(curr, levels)
    n = len(pts)
    flow = np.zeros((n, 2), np.float32)
    status = np.ones((n,), bool)
    for lvl in range(len(prev_pyr) - 1, -1, -1):
        p = prev_pyr[lvl]
        c = curr_pyr[lvl]
        s = 1.0 / (2**lvl)
        cx = pts[:, 0] * s
        cy = pts[:, 1] * s
        tpl = _np_sample_patches(p, cx, cy, half)  # (N, win, win)
        gy, gx = np.gradient(tpl, axis=(1, 2))
        axx = np.sum(gx * gx, axis=(1, 2))
        axy = np.sum(gx * gy, axis=(1, 2))
        ayy = np.sum(gy * gy, axis=(1, 2))
        det = axx * ayy - axy * axy
        ok = det > 1e-6
        status &= ok
        det = np.where(ok, det, 1.0)
        active = status.copy()
        for _ in range(iters):
            if not active.any():
                break
            patch = _np_sample_patches(c, cx + flow[:, 0], cy + flow[:, 1], half)
            diff = tpl - patch
            bx = np.sum(gx * diff, axis=(1, 2))
            by = np.sum(gy * diff, axis=(1, 2))
            dx = (ayy * bx - axy * by) / det
            dy = (axx * by - axy * bx) / det
            step = active.astype(np.float32)
            flow[:, 0] += dx * step
            flow[:, 1] += dy * step
            active &= (np.abs(dx) >= eps) | (np.abs(dy) >= eps)
        if lvl > 0:
            flow *= 2.0
    nxt = pts + flow
    H, W = curr.shape
    status &= (nxt[:, 0] >= 0) & (nxt[:, 0] < W) & (nxt[:, 1] >= 0) & (nxt[:, 1] < H)
    return nxt, status


def _np_similarity_ransac(src, dst, thresh=3.0, iters=100, seed=0):
    """estimateAffinePartial2D equivalent: RANSAC over 2-point similarity
    hypotheses + least-squares refinement on the consensus set.  Returns
    (2x3 warp or None, inlier mask)."""
    n = len(src)
    if n < 2:
        return None, np.zeros((n,), bool)

    def fit(s, d):
        # complex least squares: d ~ (a + ib) s + (tx + i ty)
        zs = s[:, 0] + 1j * s[:, 1]
        zd = d[:, 0] + 1j * d[:, 1]
        zm = zs.mean()
        dm = zd.mean()
        num = np.vdot(zs - zm, zd - dm)
        den = np.vdot(zs - zm, zs - zm).real
        ab = num / max(den, 1e-12)
        t = dm - ab * zm
        return np.array(
            [[ab.real, -ab.imag, t.real], [ab.imag, ab.real, t.imag]], np.float32
        )

    def residual(M):
        pred = src @ M[:, :2].T + M[:, 2]
        return np.linalg.norm(pred - dst, axis=1)

    rng = np.random.default_rng(seed)
    best_inl = np.zeros((n,), bool)
    for _ in range(iters):
        idx = rng.choice(n, 2, replace=False)
        if np.allclose(src[idx[0]], src[idx[1]]):
            continue
        M = fit(src[idx], dst[idx])
        inl = residual(M) < thresh
        if inl.sum() > best_inl.sum():
            best_inl = inl
    if best_inl.sum() < 2:
        return None, best_inl
    M = fit(src[best_inl], dst[best_inl])
    best_inl = residual(M) < thresh
    return M, best_inl


_CMC_REGISTRY = {
    "ecc": ECC,
    "orb": ORB,
    "sift": SIFT,
    "sof": SOF,
    "none": NoCMC,
}


def get_cmc_method(name):
    if name is None:
        return None
    key = name.strip().lower().replace("-", "_")
    if key not in _CMC_REGISTRY:
        raise ValueError(
            f"Unknown cmc_method={name!r}. Supported: {sorted(_CMC_REGISTRY)}"
        )
    return _CMC_REGISTRY[key]


def create_cmc(name, device="cuda", **kwargs):
    """A CMC estimator by name; ECC runs on ``device`` (the card unless the
    caller asks for the CPU), the others on the host."""
    cls = get_cmc_method(name)
    if cls is None:
        return None
    if cls is ECC:
        kwargs["device"] = device
    return cls(**kwargs)

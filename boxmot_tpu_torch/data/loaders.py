"""Frame sources: images, directories, globs, videos, webcams (a copy of
boxmot_tpu/data/loaders.py).

Mirror of boxmot/data/loaders.py:72-120 iter_source: yields
(path_or_index, frame_bgr) pairs with optional stride.  Video and
webcam capture go through cv2.VideoCapture when OpenCV is installed
(it is the decoder that actually ships here), falling back to imageio
(+ffmpeg) otherwise; both are gated with a clear error when no backend
can open the source.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".webp"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm"}


def _read_image(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    return rgb[..., ::-1]  # BGR convention


def _has_cv2() -> bool:
    import importlib.util

    return importlib.util.find_spec("cv2") is not None


def _iter_capture(cap, ident, vid_stride: int):
    """Drain a cv2.VideoCapture (frames arrive already BGR)."""
    import cv2

    try:
        if not cap.isOpened():
            raise RuntimeError(f"cv2.VideoCapture could not open {ident!r}")
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            if i % vid_stride == 0:
                yield ident, frame
            i += 1
    finally:
        cap.release()


def _iter_video(path: Path, vid_stride: int):
    if _has_cv2():
        import cv2

        yield from _iter_capture(cv2.VideoCapture(str(path)), path, vid_stride)
        return
    import imageio.v3 as iio

    for i, frame in enumerate(iio.imiter(path)):
        if i % vid_stride:
            continue
        yield path, np.asarray(frame)[..., ::-1]


def iter_source(source, vid_stride: int = 1):
    """Yield (identifier, frame_bgr) for any supported source:

    - int / "0": webcam index
    - video file
    - single image
    - directory of images (or a MOT sequence dir with img1/)
    - glob pattern
    """
    if isinstance(source, int) or (isinstance(source, str) and source.isdigit()):
        try:  # pragma: no cover - needs a camera
            if _has_cv2():
                import cv2

                yield from _iter_capture(
                    cv2.VideoCapture(int(source)), int(source), vid_stride
                )
                return
            import imageio.v3 as iio

            for i, frame in enumerate(iio.imiter(f"<video{int(source)}>")):
                if i % vid_stride:
                    continue
                yield int(source), np.asarray(frame)[..., ::-1]
            return
        except Exception as exc:  # pragma: no cover - needs a camera
            raise RuntimeError(f"webcam capture unavailable: {exc}") from exc

    src = Path(source)
    if src.is_dir():
        img_dir = src / "img1" if (src / "img1").is_dir() else src
        frames = sorted(
            p for p in img_dir.iterdir() if p.suffix.lower() in IMAGE_EXTS
        )
        for i, p in enumerate(frames):
            if i % vid_stride:
                continue
            yield p, _read_image(p)
        return
    if src.exists() and src.suffix.lower() in IMAGE_EXTS:
        yield src, _read_image(src)
        return
    if src.exists() and src.suffix.lower() in VIDEO_EXTS:
        yield from _iter_video(src, vid_stride)
        return
    # glob pattern (absolute or relative)
    import glob as _glob

    matches = [Path(p) for p in sorted(_glob.glob(str(source)))]
    matches = [p for p in matches if p.suffix.lower() in IMAGE_EXTS]
    if not matches:
        raise FileNotFoundError(f"no frames found for source {source!r}")
    for i, p in enumerate(matches):
        if i % vid_stride:
            continue
        yield p, _read_image(p)

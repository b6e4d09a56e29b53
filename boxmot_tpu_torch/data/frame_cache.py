"""RAM-bounded frame preload cache (a copy of boxmot_tpu/data/frame_cache.py).

Role mirror of boxmot/data/frame_cache.py:93 (two-tier RAM cache used by
the generate phase to hide image IO latency).  Tier selection:

- ``decoded``: frames are read AND decoded in a thread pool up front;
  ``read_image`` is a dict lookup returning a copy.
- ``raw``: only the file bytes live in RAM; decode happens per access.
- ``none``: budget too small — every read falls through to disk.

Decoding goes through PIL (BGR convention), matching
the JAX package's loaders, so a decoded frame's bytes equal the JAX
package's; the reference uses cv2 here, but this framework keeps cv2 out
of the data layer.
"""

from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

import numpy as np

from ..utils.logging import LOGGER as logger

_GIB = 1024**3
# Headroom left for the OS, the device runtime, and compiled kernels.
DEFAULT_MIN_FREE = 2 * _GIB
_COMPRESSED = {".jpg", ".jpeg", ".png", ".webp"}


def available_ram_bytes() -> int | None:
    """MemAvailable from /proc/meminfo, else half of physical RAM, else None."""
    meminfo = Path("/proc/meminfo")
    if meminfo.exists():
        try:
            for line in meminfo.read_text().splitlines():
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
        except (OSError, ValueError, IndexError):
            pass
    try:
        return (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")) // 2
    except (ValueError, OSError, AttributeError):
        return None


def _decode_bytes(path: Path, raw: bytes) -> np.ndarray:
    if path.suffix.lower() == ".npy":
        arr = np.load(io.BytesIO(raw))
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=2)
        elif arr.ndim == 3 and arr.shape[2] > 3:
            arr = arr[:, :, :3]
        return arr
    from PIL import Image

    with Image.open(io.BytesIO(raw)) as im:
        rgb = np.asarray(im.convert("RGB"))
    return rgb[..., ::-1]  # BGR, as everywhere else in this framework


def read_frame(path: Path) -> np.ndarray:
    """Plain disk read+decode; the no-cache fallback."""
    return _decode_bytes(Path(path), Path(path).read_bytes())


class FrameCache:
    """Preload frames into RAM under a budget; serve via ``read_image``.

    The budget is ``min(available * budget_fraction, available -
    min_free_bytes)``, split across ``n_peers`` concurrent caches.  The
    most aggressive tier that fits is chosen: decoded size is estimated
    at 15x the on-disk size for compressed formats (2x otherwise).
    """

    def __init__(
        self,
        frame_paths: list[Path],
        *,
        budget_fraction: float = 0.8,
        min_free_bytes: int = DEFAULT_MIN_FREE,
        n_peers: int = 1,
        n_threads: int | None = None,
        fallback: Callable[[Path], np.ndarray] | None = None,
    ) -> None:
        self.mode = "none"
        self._decoded: dict[str, np.ndarray] = {}
        self._raw: dict[str, bytes] = {}
        self._fallback = fallback or read_frame
        self.cached_bytes = 0

        paths = [Path(p) for p in frame_paths]
        sizes = []
        for p in paths:
            try:
                sizes.append(p.stat().st_size)
            except OSError:
                sizes.append(None)
        valid = [p for p, s in zip(paths, sizes) if s is not None]
        disk_bytes = sum(s for s in sizes if s is not None)
        if not valid:
            return

        avail = available_ram_bytes()
        if avail is None:
            return
        budget = max(0, min(avail * budget_fraction, avail - min_free_bytes))
        budget //= max(1, n_peers)
        if budget <= 0:
            logger.info("frame cache off: %.1f GB available < headroom", avail / _GIB)
            return

        workers = n_threads or min(os.cpu_count() or 4, 12)
        compressed = any(p.suffix.lower() in _COMPRESSED for p in valid)
        est_decoded = disk_bytes * (15 if compressed else 2)

        if est_decoded < budget:
            self._fill(valid, workers, decode=True)
        elif disk_bytes < budget:
            self._fill(valid, workers, decode=False)
        else:
            logger.info(
                "frame cache off: est %.1f GB decoded / %.1f GB raw vs %.1f GB budget",
                est_decoded / _GIB, disk_bytes / _GIB, budget / _GIB,
            )

    def _fill(self, paths: list[Path], workers: int, decode: bool) -> None:
        def load(p: Path):
            try:
                raw = p.read_bytes()
                return str(p), _decode_bytes(p, raw) if decode else raw
            except Exception:
                return str(p), None

        store = self._decoded if decode else self._raw
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for key, item in pool.map(load, paths):
                if item is not None:
                    store[key] = item
        if not store:
            return
        self.mode = "decoded" if decode else "raw"
        self.cached_bytes = sum(
            (v.nbytes if decode else len(v)) for v in store.values()
        )
        logger.info(
            "frame cache [%s]: %d frames, %.0f MB",
            self.mode, len(store), self.cached_bytes / 1e6,
        )

    @property
    def active(self) -> bool:
        return self.mode != "none"

    def read_image(self, path) -> np.ndarray:
        key = str(path)
        if self.mode == "decoded":
            img = self._decoded.get(key)
            if img is not None:
                return img.copy()
        elif self.mode == "raw":
            raw = self._raw.get(key)
            if raw is not None:
                try:
                    return _decode_bytes(Path(path), raw)
                except Exception:
                    pass
        return self._fallback(Path(path))

    def clear(self) -> None:
        self._decoded.clear()
        self._raw.clear()
        self.mode = "none"
        self.cached_bytes = 0

    def __enter__(self) -> "FrameCache":
        return self

    def __exit__(self, *exc) -> None:
        self.clear()

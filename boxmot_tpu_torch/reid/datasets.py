"""ReID datasets: Market-1501-style indexing, P x K sampling, transforms
(host code).

A copy of ``boxmot_tpu/reid/datasets.py``, which imports nothing of JAX:
filename-pattern indexing (``pid_cXsY_...``) of the Market-1501, DukeMTMC,
CUHK03 and VeRi-776 layouts and MSMT17's list files, identity-balanced
P x K batch sampling, and the train-time augmentations (pad and random
crop, horizontal flip, photometric jitter, blur, grayscale, random
erasing) in numpy; ``tests/test_torch_host.py`` holds it to the original.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_MARKET_RE = re.compile(r"([-\d]+)_c(\d+)")


def _index_market_dir(path: Path, relabel: bool):
    items = []
    for p in sorted(Path(path).glob("*.jpg")):
        m = _MARKET_RE.match(p.name)
        if m is None:
            continue
        pid, cam = int(m.group(1)), int(m.group(2))
        if pid == -1:
            continue  # junk images
        items.append((p, pid, cam - 1))
    if relabel:
        pids = sorted({pid for _, pid, _ in items})
        lut = {p: i for i, p in enumerate(pids)}
        items = [(p, lut[pid], cam) for p, pid, cam in items]
    return items


class Market1501:
    """Market-1501 layout: bounding_box_train / query / bounding_box_test."""

    SUBDIRS = ("Market-1501-v15.09.15",)
    TRAIN, QUERY, GALLERY = "bounding_box_train", "query", "bounding_box_test"
    EXTS = ("*.jpg",)

    def __init__(self, root: Path):
        root = Path(root)
        for sub in self.SUBDIRS:
            if (root / sub / self.TRAIN).is_dir():
                root = root / sub
                break
        if not (root / self.TRAIN).is_dir():
            raise FileNotFoundError(
                f"cannot find {type(self).__name__} under {root} "
                f"(expected {self.TRAIN}/)"
            )
        self.root = root
        self.train = self._index(root / self.TRAIN, relabel=True)
        self.query = self._index(root / self.QUERY, relabel=False)
        self.gallery = self._index(root / self.GALLERY, relabel=False)
        self.num_train_pids = len({pid for _, pid, _ in self.train})

    def _index(self, path, relabel):
        items = []
        for ext in self.EXTS:
            for p in sorted(Path(path).glob(ext)):
                m = _MARKET_RE.match(p.name)
                if m is None:
                    continue
                pid, cam = int(m.group(1)), int(m.group(2))
                if pid == -1:
                    continue  # junk images
                items.append((p, pid, cam - 1))
        if relabel:
            lut = {p: i for i, p in enumerate(sorted({pid for _, pid, _ in items}))}
            items = [(p, lut[pid], cam) for p, pid, cam in items]
        return items


class DukeMTMCreID(Market1501):
    """Same layout as Market-1501 (reference dukemtmcreid.py:1-60)."""

    SUBDIRS = ("DukeMTMC-reID", "dukemtmc-reid", "dukemtmcreid", "duke")


class CUHK03(Market1501):
    """Market-style exported CUHK03 (reference cuhk03.py:39-108)."""

    SUBDIRS = ("cuhk03", "CUHK03", "cuhk03-np")
    EXTS = ("*.jpg", "*.png")


class VeRi776(Market1501):
    """VeRi-776 vehicle ReID: image_train / image_query / image_test
    (reference veri776.py:35-78)."""

    SUBDIRS = ("VeRi", "veri776", "VeRi776", "veri")
    TRAIN, QUERY, GALLERY = "image_train", "image_query", "image_test"


class MSMT17:
    """MSMT17 list-file layout (reference msmt17.py:31-110):
    list_{train,query,gallery}.txt lines are `<relpath> <pid>`; images
    live under train/ (train split) and test/ (query/gallery)."""

    SUBDIRS = ("MSMT17_V2", "MSMT17_V1", "MSMT17", "msmt17")

    def __init__(self, root: Path, merged: bool = False):
        root = Path(root)
        if not (root / "list_train.txt").is_file():
            for sub in self.SUBDIRS:
                if (root / sub / "list_train.txt").is_file():
                    root = root / sub
                    break
        if not (root / "list_train.txt").is_file():
            raise FileNotFoundError(
                f"cannot find MSMT17 under {root} (expected list_train.txt)"
            )
        self.root = root
        self.train = self._load("list_train.txt", "train", relabel=True)
        if merged:
            extra = self._load("list_query.txt", "test", relabel=False)
            extra += self._load("list_gallery.txt", "test", relabel=False)
            offset = max((pid for _, pid, _ in self.train), default=-1) + 1
            lut = {
                pid: offset + i
                for i, pid in enumerate(sorted({pid for _, pid, _ in extra}))
            }
            self.train += [(p, lut[pid], cam) for p, pid, cam in extra]
        self.query = self._load("list_query.txt", "test", relabel=False)
        self.gallery = self._load("list_gallery.txt", "test", relabel=False)
        self.num_train_pids = len({pid for _, pid, _ in self.train})

    def _load(self, list_name, img_subdir, relabel):
        items = []
        for line in (self.root / list_name).read_text().splitlines():
            parts = line.split()
            if len(parts) != 2:
                continue
            rel, pid = parts[0], int(parts[1])
            # camera from the third filename field: 0001_001_01_... -> 1
            # (reference _parse_msmt17_list, msmt17.py:97-99)
            fields = Path(rel).name.split("_")
            cam = int(fields[2]) - 1 if len(fields) > 2 and fields[2].isdigit() else 0
            base = self.root / img_subdir if (self.root / img_subdir).is_dir() else self.root
            items.append((base / rel, pid, cam))
        if relabel:
            lut = {p: i for i, p in enumerate(sorted({pid for _, pid, _ in items}))}
            items = [(p, lut[pid], cam) for p, pid, cam in items]
        return items


DATASET_REGISTRY = {
    "market1501": Market1501,
    "dukemtmcreid": DukeMTMCreID,
    "duke": DukeMTMCreID,
    "cuhk03": CUHK03,
    "msmt17": MSMT17,
    "veri776": VeRi776,
    "veri": VeRi776,
}


def load_dataset(name: str, root: Path):
    key = name.strip().lower().replace("-", "")
    if key not in DATASET_REGISTRY:
        raise ValueError(f"unknown reid dataset {name!r}; supported: {sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[key](root)


def load_image(path: Path, hw=(256, 128)) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((hw[1], hw[0]))
    return np.asarray(im, np.float32) / 255.0


def augment(img: np.ndarray, rng: np.random.Generator, pad: int = 10,
            flip_p: float = 0.5, erase_p: float = 0.5,
            color_jitter: bool = False, gaussian_blur: bool = False,
            grayscale_p: float = 0.0) -> np.ndarray:
    """ReID train transforms: pad+crop, flip, photometric jitter
    (brightness/contrast/saturation), blur, grayscale, random erasing.

    The photometric knobs mirror the reference training-recipe options
    (boxmot/configs/training/*.yaml: color_jitter / gaussian_blur /
    random_grayscale) applied by its torchvision transform stack.
    """
    h, w = img.shape[:2]
    padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="constant")
    oy = rng.integers(0, 2 * pad + 1)
    ox = rng.integers(0, 2 * pad + 1)
    img = padded[oy : oy + h, ox : ox + w]
    if rng.uniform() < flip_p:
        img = img[:, ::-1]
    if color_jitter and rng.uniform() < 0.8:
        img = img.astype(np.float32)
        img = img * rng.uniform(0.8, 1.2)                      # brightness
        mean = img.mean()
        img = (img - mean) * rng.uniform(0.8, 1.2) + mean      # contrast
        luma = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
        sat = rng.uniform(0.8, 1.2)                            # saturation
        img = luma[..., None] + (img - luma[..., None]) * sat
        img = np.clip(img, 0.0, 1.0)
    if gaussian_blur and rng.uniform() < 0.5:
        # separable 3-tap binomial kernel, edge-padded
        k = np.asarray([0.25, 0.5, 0.25], np.float32)
        p = np.pad(img, ((1, 1), (0, 0), (0, 0)), mode="edge")
        img = p[:-2] * k[0] + p[1:-1] * k[1] + p[2:] * k[2]
        p = np.pad(img, ((0, 0), (1, 1), (0, 0)), mode="edge")
        img = p[:, :-2] * k[0] + p[:, 1:-1] * k[1] + p[:, 2:] * k[2]
    if grayscale_p > 0.0 and rng.uniform() < grayscale_p:
        luma = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
        img = np.repeat(luma[..., None], 3, axis=2)
    if rng.uniform() < erase_p:
        area = h * w
        for _ in range(10):
            target = rng.uniform(0.02, 0.4) * area
            ratio = rng.uniform(0.3, 3.33)
            eh = int(round(np.sqrt(target * ratio)))
            ew = int(round(np.sqrt(target / ratio)))
            if eh < h and ew < w:
                y = rng.integers(0, h - eh)
                x = rng.integers(0, w - ew)
                img = img.copy()
                img[y : y + eh, x : x + ew] = rng.uniform(0, 1, (eh, ew, 3))
                break
    return np.ascontiguousarray(img)


def standardize(batch: np.ndarray) -> np.ndarray:
    return (batch - IMAGENET_MEAN) / IMAGENET_STD


class PKSampler:
    """Identity-balanced sampler: P identities x K instances per batch
    (reference RandomIdentitySampler semantics)."""

    def __init__(self, items, p: int, k: int, seed: int = 0):
        self.items = items
        self.p = p
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.by_pid = {}
        for i, (_, pid, _) in enumerate(items):
            self.by_pid.setdefault(pid, []).append(i)

    def set_seed(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def sample_batch(self):
        pids = list(self.by_pid)
        p = min(self.p, len(pids))
        chosen = self.rng.choice(len(pids), size=p, replace=False)
        idxs = []
        for ci in chosen:
            pool = self.by_pid[pids[ci]]
            replace = len(pool) < self.k
            idxs.extend(self.rng.choice(pool, size=self.k, replace=replace))
        return idxs


def make_batch(items, idxs, hw=(256, 128), rng=None, train=True, aug_kwargs=None):
    imgs, pids = [], []
    for i in idxs:
        path, pid, _ = items[i]
        img = load_image(path, hw)
        if train and rng is not None:
            img = augment(img, rng, **(aug_kwargs or {}))
        imgs.append(img)
        pids.append(pid)
    return standardize(np.stack(imgs)), np.asarray(pids, np.int32)

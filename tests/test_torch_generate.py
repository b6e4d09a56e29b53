"""The port's cache generation (``engine/generate.py``, with
``data/cache.py::AppendableNpyWriter`` and ``data/frame_cache.py``)
against the JAX package's, on the CPU.

The same inputs go through both packages' ``run_generate``: on MOT17-02
(4 frames of 1080p) the yololite-seg predictor with the JAX package's weights carried
into the port (``yololite_state_dict_from_flax``), osnet_x0_25 from one
seeded torchreid-format checkpoint (64 x 32 crops) and ECC.  Tolerances:
detection rows of the same frames and count, values within 1e-3; packed
mask bits equal except pixels whose probability lies within 1e-5 of 0.5;
embeddings within 1e-4 (the JAX fill run over the port's det cache, so
both crop the same boxes); warps within 1e-3 in the linear part and 1e-3
px at ECC's working scale 0.15 in the translation (1e-3 / 0.15 px).  The
JAX ``run_eval`` reads the port's caches with the metrics of the port's
``run_eval`` (BoT-SORT with embeddings and warps, sam2mot with masks).
Resumed runs, the embeddings-only fill and ``frame_group`` are held to one
uninterrupted run of the port.  ``tests/test_torch_generate_host.py``
holds the writer, the frame cache and the model-free paths.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from boxmot_tpu.data import cache as jcache
from boxmot_tpu.detectors import registry as jregistry
from boxmot_tpu.engine import generate as jgenerate
from boxmot_tpu.engine.eval import run_eval as jax_run_eval
from boxmot_tpu.reid.core import ReID as JaxReID
from boxmot_tpu_torch.data import cache as tcache
from boxmot_tpu_torch.data.mot import MOTDataset
from boxmot_tpu_torch.detectors import create_detector
from boxmot_tpu_torch.engine import generate as tgenerate
from boxmot_tpu_torch.engine.eval import run_eval
from boxmot_tpu_torch.models.convert import yololite_state_dict_from_flax
from boxmot_tpu_torch.reid import ReID
from chip_smoke import reid_checkpoint

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / "MOT17-mini" / "train"
SEQ = "MOT17-02-FRCNN"
DET = "yololite-seg"
CROP_HW = (64, 32)
ECC_SCALE = 0.15  # ECC's default working scale
CONF = 0.61  # about 20 detections a frame (sam2mot's eval unpacks each mask to 1080p)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


class FakeReID:
    """Deterministic features from the boxes (no backbone)."""

    feature_dim = 8
    model_name = "fake_reid"

    def get_features(self, boxes, img):
        out = np.zeros((len(boxes), 8), np.float32)
        out[:, :4] = np.asarray(boxes, np.float32) / 1000.0
        out[:, 4] = img[0, 0, 0]
        return out

    def get_features_multi(self, boxes_per_frame, imgs):
        return [self.get_features(b, i) for b, i in zip(boxes_per_frame, imgs)]


def npy_files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.npy"))}


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Both packages' caches of MOT17-02, and the models that wrote them:
    the JAX run writes dets, masks and warps; the port's run all four."""
    tmp = tmp_path_factory.mktemp("generate")
    data = tmp / "data"
    data.mkdir()
    (data / SEQ).symlink_to(FIXTURE / SEQ, target_is_directory=True)
    ckpt = reid_checkpoint(tmp, "osnet_x0_25", seed=3, crop_hw=CROP_HW)
    jdet = jregistry.create_detector(f"{DET}.pt", conf=CONF)
    tdet = create_detector(f"{DET}.pt", device="cpu", conf=CONF)
    tdet.model.model.load_state_dict(yololite_state_dict_from_flax(
        jax.tree.map(np.asarray, jdet.model.variables), "segment"))
    jax_stats = jgenerate.run_generate(data, tmp / "jax", detector=DET, detector_model=jdet,
                                       cmc_method="ecc")
    treid = ReID(weights=ckpt, device="cpu", crop_hw=CROP_HW)
    stats = tgenerate.run_generate(data, tmp / "port", detector=DET, detector_model=tdet,
                                   reid_model=treid, cmc_method="ecc", device="cpu")
    return {"tmp": tmp, "data": data, "ckpt": ckpt, "tdet": tdet, "treid": treid,
            "jax_stats": jax_stats, "stats": stats}


def test_caches_equal_jax(generated):
    """Detections, masks and warps against the JAX run's; embeddings against
    the JAX fill over the port's det cache."""
    tmp, stats = generated["tmp"], generated["stats"]
    assert {**stats[SEQ], "embs": 0} == generated["jax_stats"][SEQ]  # the JAX run had no ReID
    assert stats[SEQ]["embs"] == stats[SEQ]["dets"] > 0
    dets = {}
    for name in ("jax", "port"):
        dets[name] = np.load(tcache.det_cache_path(tmp / name, DET, SEQ))
    np.testing.assert_array_equal(dets["port"][:, 0], dets["jax"][:, 0])
    np.testing.assert_allclose(dets["port"], dets["jax"], rtol=0, atol=1e-3)

    # mask bits: a pixel may differ only where its probability is within 1e-5 of 0.5
    masks = {name: np.load(tcache.mask_cache_path(tmp / name, DET, SEQ)) for name in dets}
    np.testing.assert_array_equal(masks["port"][:, 0], masks["jax"][:, 0])
    side = tcache.MASK_SIDE
    bits = {k: np.unpackbits(v[:, 1:].astype(np.uint8), axis=-1)[:, : side * side]
            for k, v in masks.items()}
    differ = bits["port"] != bits["jax"]
    near = np.zeros_like(differ)
    seq = MOTDataset(generated["data"]).sequences[0]
    frames = masks["port"][:, 0].astype(int)
    for f in np.unique(frames[differ.any(1)]):  # the frames with a differing bit
        img = tgenerate.load_frame(seq.img_paths[f - 1])
        probs = generated["tdet"].model(img, conf=CONF)[0].masks.data
        H, W = probs.shape[1:]
        ys = (np.arange(side) * (H / side)).astype(int).clip(0, H - 1)
        xs = (np.arange(side) * (W / side)).astype(int).clip(0, W - 1)
        assert len(probs) == (frames == f).sum()
        near[frames == f] = (np.abs(probs[:, ys][:, :, xs] - 0.5) <= 1e-5).reshape(len(probs), -1)
    assert not (differ & ~near).any()
    print(f"mask bits: {int(differ.sum())} of {differ.size} differ, each within 1e-5 of 0.5")

    warps = {name: np.load(tcache.warp_cache_path(tmp / name, "ecc", SEQ)) for name in dets}
    np.testing.assert_array_equal(warps["port"][:, 0], np.arange(1, 5))
    lin, trans = [1, 2, 4, 5], [3, 6]
    np.testing.assert_allclose(warps["port"][:, lin], warps["jax"][:, lin], rtol=0, atol=1e-3)
    np.testing.assert_allclose(warps["port"][:, trans], warps["jax"][:, trans], rtol=0,
                               atol=1e-3 / ECC_SCALE)

    # embeddings: the JAX fill over the port's det rows
    jreid = JaxReID(weights=generated["ckpt"], crop_hw=CROP_HW)
    jpath = tmp / "jax_embs.npy"
    jgenerate._fill_embeddings(seq, jcache.load_cached_dets_per_frame(
        tcache.det_cache_path(tmp / "port", DET, SEQ), seq.seq_length), jpath, jreid)
    got = np.load(tcache.emb_cache_path(tmp / "port", DET, "osnet_x0_25", SEQ))
    want = np.load(jpath)
    assert got.shape == want.shape == (len(dets["port"]), 513)
    np.testing.assert_array_equal(got[:, 0], dets["port"][:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_jax_run_eval_reads_the_port_caches(generated):
    """The port's embedding, warp and mask caches, read by the JAX
    ``run_eval`` and by the port's: the same metrics."""
    root, data = generated["tmp"] / "port", generated["data"]
    for tracker, kw in (("botsort", {"reid": "osnet_x0_25", "cmc_method": "ecc"}),
                        ("sam2mot", {})):
        want = jax_run_eval(data, tracker, cache_root=root, detector=DET, **kw)["combined"]
        got = run_eval(data, tracker, cache_root=root, detector=DET, device="cpu",
                       **kw)["combined"]
        for key in ("HOTA", "MOTA", "IDF1", "CLR_FP", "IDSW"):
            assert got[key] == want[key], (tracker, key)
        assert want["CLR_FP"] > 0  # the tracks were read and scored


def test_resumed_runs_equal_one_run(generated, tmp_path):
    """Caches cut at frame 2 (dets, masks, warps) and mid-frame 3
    (embeddings), then resumed: byte-equal to the uninterrupted run."""
    full = generated["tmp"] / "port"
    rels = {"det": (Path(DET) / "dets" / f"{SEQ}.npy", 2),
            "mask": (Path(DET) / "masks" / "seg" / f"{SEQ}.npy", 2),
            "warp": (Path("warps") / "ecc" / f"{SEQ}.npy", 2)}
    for rel, last_frame in rels.values():
        rows = np.load(full / rel)
        with tcache.AppendableNpyWriter(tmp_path / rel, rows.shape[1]) as w:
            w.append(rows[rows[:, 0] <= last_frame])
    erel = Path(DET) / "embs" / "osnet_x0_25" / "resize" / f"{SEQ}.npy"
    embs = np.load(full / erel)
    cut = int((embs[:, 0] <= 2).sum()) + 5
    with tcache.AppendableNpyWriter(tmp_path / erel, embs.shape[1]) as w:
        w.append(embs[:cut])
    tgenerate.run_generate(generated["data"], tmp_path, detector=DET,
                           detector_model=generated["tdet"], reid_model=generated["treid"],
                           cmc_method="ecc", device="cpu")
    assert npy_files(tmp_path) == npy_files(full)


def test_embeddings_only_fill_and_frame_group(generated, tmp_path):
    """A det-only run, then a ReID-only run over its cache: the uninterrupted
    run's bytes, the det cache untouched; frame_group 4 (all four frames'
    crops in one backbone batch) within 1e-5 of frame_group 1."""
    full, data = generated["tmp"] / "port", generated["data"]
    tgenerate.run_generate(data, tmp_path / "a", detector=DET, detector_model=generated["tdet"])
    stats = tgenerate.run_generate(data, tmp_path / "a", detector=DET,
                                   reid_model=generated["treid"])
    assert stats[SEQ]["embs"] == stats[SEQ]["dets"] == generated["stats"][SEQ]["dets"]
    want = npy_files(full)
    got = npy_files(tmp_path / "a")
    assert {k: v for k, v in want.items() if not k.startswith("warps")} == got

    shutil.copytree(full / DET / "dets", tmp_path / "g" / DET / "dets")
    calls = []
    reid = generated["treid"]
    real = reid.get_features_multi

    def multi(boxes, imgs):
        calls.append(len(imgs))
        return real(boxes, imgs)

    reid.get_features_multi = multi
    try:
        tgenerate.run_generate(data, tmp_path / "g", detector=DET, reid_model=reid, frame_group=4)
    finally:
        del reid.get_features_multi
    assert calls == [4]
    rel = Path(DET) / "embs" / "osnet_x0_25" / "resize" / f"{SEQ}.npy"
    np.testing.assert_allclose(np.load(tmp_path / "g" / rel), np.load(full / rel), rtol=0,
                               atol=1e-5)

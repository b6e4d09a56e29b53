"""The port's replay and eval against the JAX package and its pinned metrics.

The port's ``run_eval`` on the CPU must reproduce the JAX package's
ByteTrack pins on both fixtures; the mirrored host pieces (bucket
constants, ``pack_frames``, MOT row unpacking, the YAML defaults and the
resolved replay config) must equal the originals; and importing the port
and running its eval must leave JAX out of the process.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import boxmot_tpu.engine.replay as jreplay
import chip_smoke
from boxmot_tpu.configs import get_tracker_defaults as jax_defaults
from boxmot_tpu.engine.eval import build_replay_config as jax_build_replay_config
from boxmot_tpu_torch import run_eval
from boxmot_tpu_torch.configs import get_tracker_defaults
from boxmot_tpu_torch.engine import replay as treplay
from boxmot_tpu_torch.engine.eval import build_replay_config
from tests.test_pinned_metrics import ATOL, PINNED, ROOTS, assert_pinned

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("root_name", ["mot17_mini", "synth_long"])
def test_port_eval_reproduces_pins_on_cpu(root_name, tmp_path):
    res = run_eval(ROOTS[root_name], "bytetrack", device="cpu", output_dir=tmp_path)
    assert_pinned(res["combined"], PINNED[(root_name, "bytetrack")])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(res["per_seq"]) and res["per_seq"]


def test_cache_fed_eval_equals_jax(tmp_path):
    """Detections from a det cache, filtered by min_det_conf, on a subset of
    sequences: the port's metrics and MOT rows equal the JAX run_eval's.
    The cache differs from det.txt (every other detection's confidence is
    scaled into ByteTrack's second pass, and the filter drops those), so
    ignoring the cache or the filter changes the rows."""
    from boxmot_tpu.data.cache import AppendableNpyWriter, det_cache_path
    from boxmot_tpu.data.mot import MOTDataset
    from boxmot_tpu.engine.eval import run_eval as jax_run_eval

    root, seq_name = ROOTS["mot17_mini"], "MOT17-04-FRCNN"
    for seq in MOTDataset(root):
        with AppendableNpyWriter(det_cache_path(tmp_path / "cache", "fixturedet", seq.name), 7) as w:
            for f, dets in enumerate(seq.dets_per_frame(), start=1):
                dets = dets.copy()
                dets[::2, 4] *= 0.55
                w.append(np.concatenate([np.full((len(dets), 1), f, np.float32), dets], axis=1))
    cache = dict(cache_root=tmp_path / "cache", detector="fixturedet")

    def rows(out, **kw):
        run_eval(root, "bytetrack", device="cpu", output_dir=tmp_path / out, seq_names=[seq_name], **kw)
        return np.loadtxt(tmp_path / out / f"{seq_name}.txt", delimiter=",")

    got = run_eval(root, "bytetrack", device="cpu", output_dir=tmp_path / "port",
                   min_det_conf=0.6, seq_names=[seq_name], **cache)
    want = jax_run_eval(root, "bytetrack", output_dir=tmp_path / "jax", min_det_conf=0.6,
                        seq_names=[seq_name], **cache)
    assert list(got["per_seq"]) == list(want["per_seq"]) == [seq_name]
    for k in ("HOTA", "MOTA", "IDF1"):
        assert got["combined"][k] == want["combined"][k], k
    port = np.loadtxt(tmp_path / "port" / f"{seq_name}.txt", delimiter=",")
    assert len(port) > 50
    np.testing.assert_array_equal(port, np.loadtxt(tmp_path / "jax" / f"{seq_name}.txt", delimiter=","))
    for other in (rows("public", min_det_conf=0.6), rows("unfiltered", **cache)):
        assert other.shape != port.shape or not np.array_equal(other, port)


def test_replay_rows_equal_jax_replay():
    """The port's MOT rows for synth-long against the JAX replay's."""
    from boxmot_tpu.data.mot import MOTDataset

    seq = MOTDataset(ROOTS["synth_long"]).sequences[0]
    dets = seq.dets_per_frame()[:120]
    want = jreplay.replay_sequence(jax_build_replay_config("bytetrack"), dets)
    got = treplay.replay_sequence(build_replay_config("bytetrack"), dets, device="cpu")
    assert got.shape == want.shape
    keys = [0, 1, 6, 7, 8]  # frame, id, conf, cls, det_ind
    np.testing.assert_array_equal(got[:, keys], want[:, keys])
    assert np.abs(got[:, 2:6] - want[:, 2:6]).max() <= 1  # whole-pixel tlwh


def test_chip_smoke_pins_equal_the_suite_pins():
    from tests.test_torch_obb import JAX_OBB_EVAL

    from tests.test_torch_occluboost import JAX_OBB_EVAL as OCCLUBOOST_OBB_EVAL

    assert chip_smoke.PINNED == {k: v for k, v in PINNED.items() if ":" not in k[1]}
    assert len(chip_smoke.PINNED) == 20
    assert chip_smoke.OBB_EVAL == {**JAX_OBB_EVAL, "occluboost": OCCLUBOOST_OBB_EVAL}
    assert chip_smoke.ATOL == ATOL


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """No card, or no checkout around the script: non-zero exit, no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = REPO / "chip_smoke.py"
    if alone:
        script = tmp_path / "chip_smoke.py"
        script.write_bytes((REPO / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent, capture_output=True,
                         text=True, timeout=120, env={k: v for k, v in os.environ.items()
                                                       if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_synthetic_frames_equal_bench():
    import bench

    for a, b in zip(chip_smoke.synthetic_frames(20, 100, seed=3), bench.synthetic_frames(20, 100, seed=3)):
        np.testing.assert_array_equal(a, b)
    assert (chip_smoke.N_SEQS, chip_smoke.N_FRAMES, chip_smoke.N_DETS, chip_smoke.CAPACITY) == (
        bench.N_SEQS, bench.N_FRAMES, bench.N_DETS, bench.CAPACITY)


def test_mirrored_defaults_and_configs_equal_jax():
    for name in ("bytetrack", "sfsort", "ocsort", "botsort", "deepocsort", "boosttrack",
                 "occluboost", "strongsort", "hybridsort", "sam2mot"):
        assert get_tracker_defaults(name) == jax_defaults(name), name
    assert get_tracker_defaults("nosuch") == jax_defaults("nosuch") == {}
    for params in ({}, {"match_thresh": 0.7, "max_time_lost": 40, "track_buffer": 5}):
        got = dataclasses.asdict(build_replay_config("bytetrack", **params))
        assert got == dataclasses.asdict(jax_build_replay_config("bytetrack", **params))
    cfg = build_replay_config("bytetrack")
    # YAML keys that are not fields are dropped: the replay keeps 0.45 and 25
    assert (cfg.track_thresh, cfg.match_thresh, cfg.det_thresh, cfg.max_time_lost) == (0.6, 0.9, 0.45, 25)
    for name in ("strongsort", "hybridsort"):
        assert dataclasses.asdict(build_replay_config(name)) == \
            dataclasses.asdict(jax_build_replay_config(name))
    # a host tracker has no replay config, and an unknown name none either
    with pytest.raises(ValueError, match="No replay config"):
        build_replay_config("sam2mot")
    with pytest.raises(ValueError, match="Unknown tracker"):
        build_replay_config("nosuch")


def test_pack_frames_and_buckets_equal_jax():
    assert treplay.FRAME_BUCKETS == jreplay.FRAME_BUCKETS
    assert treplay.DET_BUCKETS == jreplay.DET_BUCKETS
    for n in (1, 8, 9, 256):
        assert treplay._bucket(n, treplay.DET_BUCKETS) == jreplay._bucket(n, jreplay.DET_BUCKETS)
    with pytest.raises(ValueError):
        treplay._bucket(3000, treplay.FRAME_BUCKETS)
    rng = np.random.default_rng(0)
    frames = [rng.uniform(0, 100, (n, 6)).astype(np.float32) for n in (3, 0, 11, 5)]
    for kw in ({}, {"D": 32, "F": 128}, {"det_cols": 5}):
        cols = kw.get("det_cols", 6)
        fr = [f[:, :cols] for f in frames]
        got, n_got = treplay.pack_frames(fr, **kw)
        want, n_want = jreplay.pack_frames(fr, **kw)
        np.testing.assert_array_equal(got, want)
        assert n_got == n_want


def test_unpack_mot_rows_equals_jax():
    rng = np.random.default_rng(1)
    outs = rng.uniform(0, 500, (6, 16, 8)).astype(np.float32)
    masks = rng.uniform(size=(6, 16)) < 0.4
    masks[2] = False
    for offset in (0, 7):
        np.testing.assert_array_equal(treplay._unpack_mot_rows(outs, masks, 5, offset),
                                      jreplay._unpack_mot_rows(outs, masks, 5, offset))
    assert treplay._unpack_mot_rows(outs, np.zeros_like(masks), 6).shape == (0, 9)


def test_port_import_and_eval_leave_jax_out():
    """The port, driven through its evals (ByteTrack, SFSORT OBB, OC-SORT,
    BoT-SORT, BoT-SORT OBB, DeepOCSORT, BoostTrack, OccluBoost, StrongSORT,
    HybridSORT, sam2mot) and its live API (ByteTrack, OC-SORT, BoT-SORT with
    its default SOF and with ECC, DeepOCSORT with ECC and embeddings,
    BoostTrack with ECC, OccluBoost with its default SOF, StrongSORT and
    HybridSORT with ECC and embeddings, sam2mot) and its ReID (BoT-SORT and
    DeepOCSORT computing their embeddings with ``reid_weights``, the facade's
    ``get_features_multi`` on rotated boxes) and its detector API (a seeded
    YOLOX through ``YoloXDetector``, ``Detector``, ``DetectorReIDPipeline``
    and the fused ``FusedLiveTracker`` with OccluBoost and OSNet; the
    yololite predictor through ``create_detector`` and ``run_generate`` with
    it, OSNet and ECC), loads neither JAX, nor yaml, nor any module of the
    JAX package."""
    code = (
        "import sys, torch\n"
        "import numpy as np\n"
        "torch.set_num_threads(1)\n"
        "import boxmot_tpu_torch\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'bytetrack', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.649859) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval_obb('assets/mmot-mini/train', 'sfsort', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.898815) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'ocsort', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.651511) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'botsort', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.652681) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'deepocsort', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.652269) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval_obb('assets/mmot-mini/train', 'botsort', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.575946) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'boosttrack', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.649366) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'occluboost', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.649804) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'strongsort', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.466670) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'hybridsort', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.653064) <= 1e-4\n"
        "res = boxmot_tpu_torch.run_eval('assets/MOT17-mini/train', 'sam2mot', device='cpu')\n"
        "assert abs(res['combined']['HOTA'] - 0.658509) <= 1e-4\n"
        "dets = np.array([[10, 10, 50, 90, 0.9, 0], [200, 40, 260, 160, 0.8, 2]], np.float32)\n"
        "embs = np.random.default_rng(0).normal(size=(2, 512)).astype(np.float32)\n"
        "img = np.random.default_rng(1).integers(0, 255, (480, 640, 3)).astype(np.uint8)\n"
        "for name, kw in (('bytetrack', {}), ('ocsort', {}), ('botsort', {}),\n"
        "                 ('botsort', {'cmc_method': 'ecc', 'per_class': False}),\n"
        "                 ('deepocsort', {'per_class': False}),\n"
        "                 ('boosttrack', {'per_class': False}), ('occluboost', {}),\n"
        "                 ('strongsort', {'per_class': False, 'min_conf': 0.1}),\n"
        "                 ('hybridsort', {'per_class': False, 'min_hits': 3}),\n"
        "                 ('sam2mot', {'min_hits': 3})):\n"
        "    trk = boxmot_tpu_torch.create_tracker(name, device='cpu', **{'per_class': True, **kw})\n"
        "    for _ in range(3):\n"
        "        out = trk.update(dets, img, embs if name != 'bytetrack' else None)\n"
        "    assert out.shape == (2, 8) and sorted(out.id) == [1, 2], out\n"
        "for name in ('botsort', 'deepocsort'):\n"
        "    trk = boxmot_tpu_torch.create_tracker(name, device='cpu', reid_weights='osnet_x0_25',\n"
        "                                          use_cmc=False, cmc_off=True)\n"
        "    for _ in range(3):\n"
        "        out = trk.update(dets, img)\n"
        "    assert out.shape == (2, 8) and type(trk.model).__name__ == 'ReID', out\n"
        "from boxmot_tpu_torch.reid import create_reid\n"
        "obb = np.array([[30, 50, 20, 40, 0.3], [230, 100, 30, 60, -2.0]], np.float32)\n"
        "f = create_reid(device='cpu', crop_hw=(64, 32)).get_features_multi([obb, obb[:1]], [img, img])\n"
        "assert [a.shape for a in f] == [(2, 512), (1, 512)]\n"
        "from boxmot_tpu_torch.detectors import create_detector\n"
        "from boxmot_tpu_torch.detectors.detector import Detector\n"
        "from boxmot_tpu_torch.engine.fused import FusedLiveTracker\n"
        "from boxmot_tpu_torch.engine.inference import DetectorReIDPipeline\n"
        "det = create_detector('yolox_nano.pt', device='cpu', imgsz=(64, 96))\n"
        "assert len(det(img)) > 0 and len(Detector(det).predict_frame(img)) > 0\n"
        "reid = create_reid(device='cpu', crop_hw=(64, 32))\n"
        "pipe = DetectorReIDPipeline(det, reid, skip_frame_errors=False)\n"
        "d, e, _ = pipe(img)\n"
        "assert e.shape == (len(d), 512) and pipe.failed_frames == 0\n"
        "fused = FusedLiveTracker(det, reid, 'occluboost', {'det_thresh': 0.1,\n"
        "                         'new_track_thresh': 0.1}, max_dets=16)\n"
        "rows = [fused.update(img) for _ in range(3)][-1]\n"
        "assert len(rows) > 0 and rows.shape[1] == 8, rows\n"
        "import pathlib, tempfile\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    data = pathlib.Path(tmp) / 'data'\n"
        "    data.mkdir()\n"
        "    (data / 'MOT17-02-FRCNN').symlink_to(pathlib.Path('assets/MOT17-mini/train/'\n"
        "                                                      'MOT17-02-FRCNN').resolve())\n"
        "    lite = create_detector('yololite.pt', device='cpu')\n"
        "    assert type(lite).__name__ == 'UltralyticsDetector' and len(lite(img)) > 0\n"
        "    s = boxmot_tpu_torch.run_generate(data, pathlib.Path(tmp) / 'cache', detector='yl',\n"
        "                                      detector_model=lite, reid_model=reid,\n"
        "                                      cmc_method='ecc', device='cpu')\n"
        "    assert s.total_dets == s.total_embs > 0 and s['MOT17-02-FRCNN']['warps'] == 4, s\n"
        "from boxmot_tpu_torch.reid import ReID\n"
        "f = ReID(model_name='clip', device='cpu', crop_hw=(64, 32)).get_features(\n"
        "    np.array([[10, 20, 60, 120], [200, 40, 260, 160]], np.float32), img)\n"
        "assert f.shape == (2, 1280) and np.isfinite(f).all()\n"
        "from boxmot_tpu_torch.reid.training.trainer import ReIDTrainer, TrainConfig\n"
        "trainer = ReIDTrainer(TrainConfig(model='osnet_x0_25', data_root='assets/reid-mini',\n"
        "                                  crop_hw=(64, 32), p=2, k=2, steps=2, warmup_steps=1),\n"
        "                      device='cpu')\n"
        "hist = trainer.fit(log_every=1)\n"
        "assert len(hist) == 2 and all(np.isfinite(h['loss']) for h in hist), hist\n"
        "assert 0 <= trainer.evaluate()['mAP'] <= 1\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'flax', 'yaml', 'click')\n"
        "       or m == 'boxmot_tpu' or m.startswith('boxmot_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["run_eval", "run_eval_obb", "create_tracker", "replay_sequence",
                                   "replay_sequences_batched", "replay_sequences_outputs"])
def test_entry_points_default_to_the_card(entry):
    """``device`` defaults to "cuda"; without a card the default raises and
    never falls back to the CPU."""
    import inspect

    import boxmot_tpu_torch

    fn = getattr(boxmot_tpu_torch, entry, None) or getattr(treplay, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    cfg = build_replay_config("bytetrack")
    dets = [np.array([[10, 10, 50, 90, 0.9, 0]], np.float32)]
    args = {"run_eval": (ROOTS["mot17_mini"],), "run_eval_obb": (REPO / "assets/mmot-mini/train",),
            "create_tracker": ("bytetrack",), "replay_sequence": (cfg, dets)}.get(
                entry, (cfg, [{"dets": dets}]))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(*args)


def test_replay_refuses_a_capped_auction(monkeypatch):
    """A solve that stops at the iteration cap makes the replay raise."""
    from boxmot_tpu_torch.trackers import bytetrack as tbt

    real = tbt.masked_assignment
    monkeypatch.setattr(tbt, "masked_assignment",
                        lambda *a, **k: real(*a, **dict(k, max_iters=0)))
    from boxmot_tpu.data.mot import MOTDataset

    dets = MOTDataset(ROOTS["synth_long"]).sequences[0].dets_per_frame()[:5]
    with pytest.raises(RuntimeError, match="iteration cap"):
        treplay.replay_sequence(build_replay_config("bytetrack"), dets, device="cpu")

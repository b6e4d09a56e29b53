"""The port's KF-noise calibration (a host copy of
``boxmot_tpu/motion/calibration.py``) and ``run_eval``'s ``kf_noise``
against the JAX package's, on the CPU.

``estimate_kf_noise`` on MOT17-mini (every KF parameterization, with and
without a detection cache for R, per class) and the JSON it saves must equal
JAX's; ``load_kf_noise_params`` must read the same overrides from a path or
a dict; ``run_eval(kf_noise=...)`` must give JAX's metrics within 1e-4.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from boxmot_tpu.engine.eval import load_kf_noise_params as jax_load
from boxmot_tpu.engine.eval import run_eval as jax_run_eval
from boxmot_tpu.motion import calibration as jcal
from boxmot_tpu_torch.data.mot import MOTDataset
from boxmot_tpu_torch.engine.eval import load_kf_noise_params, run_eval
from boxmot_tpu_torch.motion import calibration as tcal
from tests.test_pinned_metrics import ROOTS

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """The JAX reference replays its sequences on one CPU device: the suite's
    eight virtual devices would shard them, which gives the same rows and
    compiles several times slower."""
    import jax

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda backend=None: real(backend)[:1])


def assert_same(got, want, path="result"):
    """Nested dicts, lists and arrays equal to the bit, keys and types too."""
    assert type(got) is type(want), f"{path}: {type(got)} vs {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), f"{path}: {got} vs {want}"


@pytest.fixture(scope="module")
def det_cache(tmp_path_factory):
    """A .npy detection file per MOT17-mini sequence, [frame, x1, y1, x2, y2,
    conf, cls] rows from its det.txt, as ``tune-kf --dets`` reads."""
    root = tmp_path_factory.mktemp("dets")
    for seq in MOTDataset(ROOTS["mot17_mini"]):
        rows = [np.concatenate([np.full((len(d), 1), f), d], 1)
                for f, d in enumerate(seq.dets_per_frame(), start=1) if len(d)]
        np.save(root / f"{seq.name}.npy", np.concatenate(rows).astype(np.float32))
    return root


@pytest.mark.parametrize("kf_type", ["xywh", "xyah", "xysr", "xyhr"])
def test_estimate_kf_noise_equals_jax(kf_type, det_cache, tmp_path):
    for kw in ({}, {"dets_root": det_cache, "iou_threshold": 0.3}, {"per_class": True}):
        got = tcal.estimate_kf_noise(ROOTS["mot17_mini"], kf_type=kf_type, **kw)
        want = jcal.estimate_kf_noise(ROOTS["mot17_mini"], kf_type=kf_type, **kw)
        assert_same(got, want)
    tcal.save_kf_noise(got, tmp_path / "port.json")
    jcal.save_kf_noise(want, tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_calibration_helpers_equal_jax():
    assert tcal.TRACKER_KF_TYPE == jcal.TRACKER_KF_TYPE
    for name in (*jcal.TRACKER_KF_TYPE, "SFSORT", "nosuch"):
        assert tcal.tracker_kf_type(name) == jcal.tracker_kf_type(name)
    seq = ROOTS["mot17_mini"] / "MOT17-04-FRCNN"
    for kf_type in ("xyah", "xysr"):
        got = tcal.build_tracks_from_sequence(seq, kf_type=kf_type, min_detections=3)
        want = jcal.build_tracks_from_sequence(seq, kf_type=kf_type, min_detections=3)
        assert_same(got, want)


def test_load_kf_noise_params_equals_jax(tmp_path):
    blob = {"std_weight_position": 0.0023, "std_weight_velocity": 0.001, "Q": [[1.0]],
            "kf_type": "xyah"}
    path = tmp_path / "kf.json"
    path.write_text(json.dumps(blob))
    for arg in (blob, path, str(path), {"kf_type": "xyah"}, {"std_weight_velocity": 1}):
        assert_same(load_kf_noise_params(arg), jax_load(arg))


def _metrics(res) -> dict:
    return {k: float(res["combined"][k]) for k in ("HOTA", "MOTA", "IDF1")}


def test_run_eval_kf_noise_equals_jax(tmp_path):
    """A tune-kf JSON of MOT17-mini into ByteTrack's eval, and an explicit
    tracker param that beats the file: JAX's metrics, and the calibration
    changes the result."""
    est = tcal.estimate_kf_noise(ROOTS["mot17_mini"], kf_type="xyah")
    path = tmp_path / "kf.json"
    tcal.save_kf_noise(est, path)
    got = run_eval(ROOTS["mot17_mini"], "bytetrack", device="cpu", kf_noise=path)
    want = jax_run_eval(ROOTS["mot17_mini"], "bytetrack", kf_noise=path)
    plain = run_eval(ROOTS["mot17_mini"], "bytetrack", device="cpu")
    for k in ("HOTA", "MOTA", "IDF1"):
        assert abs(got["combined"][k] - want["combined"][k]) <= ATOL, k
    assert _metrics(got) != _metrics(plain)
    params = {"std_weight_position": 1.0 / 20}
    beaten = run_eval(ROOTS["mot17_mini"], "bytetrack", device="cpu", kf_noise=path,
                      tracker_params=params)
    direct = run_eval(ROOTS["mot17_mini"], "bytetrack", device="cpu", tracker_params={
        "std_weight_velocity": est["std_weight_velocity"], **params})
    assert _metrics(beaten) == _metrics(direct)

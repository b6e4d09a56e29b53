"""The port's ``Boxmot`` facade and functional API (``boxmot_tpu_torch.api``)
against the JAX package's, on the CPU.

``Boxmot(device="cpu")``'s ``track`` and ``val`` and the functional
``track`` and ``evaluate`` give the JAX facade's rows (ids and ``det_ind``
exact, boxes within 1e-4) and metrics (within 1e-4); ``train`` for 2 steps
is the port's ``ReIDTrainer`` run directly; ``eval_reid`` is the port's
evaluator, on a model name and on a torchreid checkpoint; ``export`` takes
the JAX facade's arguments (``tune``, ``research`` and ``export`` are held
to the JAX package in tests/test_torch_{tuning,research,export}.py); the
default device is the card, with no fallback to the CPU.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import boxmot_tpu
import chip_smoke
from boxmot_tpu_torch import api
from boxmot_tpu_torch.api import Boxmot
from tests.test_pinned_metrics import PINNED, ROOTS

ATOL = 1e-4
SEQ = ROOTS["mot17_mini"] / "MOT17-04-FRCNN"
REID_MINI = ROOTS["mot17_mini"].parent.parent / "reid-mini"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """The JAX reference replays its sequences on one CPU device (see
    tests/test_torch_cli.py)."""
    import jax

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda backend=None: real(backend)[:1])


def assert_rows_equal(got, want):
    """Per-frame TrackResults: ids, cls and det_ind exact, boxes and conf
    within 1e-4."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, [4, 6, 7]], w[:, [4, 6, 7]])
        np.testing.assert_allclose(g[:, [0, 1, 2, 3, 5]], w[:, [0, 1, 2, 3, 5]], atol=ATOL, rtol=0)


@pytest.mark.parametrize("tracker", [None, "ocsort", {"name": "bytetrack",
                                                      "config": {"track_thresh": 0.5}}])
def test_track_equals_jax(tracker, tmp_path):
    got = Boxmot(tracker=tracker, device="cpu").track(source=SEQ, save_txt=tmp_path / "p.txt")
    want = boxmot_tpu.Boxmot(tracker=tracker).track(source=SEQ, save_txt=tmp_path / "j.txt")
    assert_rows_equal(got, want)
    assert sum(len(r) for r in got) > 20
    p, j = (np.loadtxt(tmp_path / n, delimiter=",", ndmin=2) for n in ("p.txt", "j.txt"))
    np.testing.assert_array_equal(p[:, [0, 1, 7, 8]], j[:, [0, 1, 7, 8]])
    np.testing.assert_allclose(p, j, atol=ATOL, rtol=0)


def test_functional_track_and_an_image_dir_equal_jax():
    got = api.track(SEQ, tracker="sfsort", device="cpu", show_timing=True)
    assert_rows_equal(got, boxmot_tpu.track(SEQ, tracker="sfsort"))
    # a plain image directory: no det.txt, so every frame is empty
    got = Boxmot(device="cpu").track(source=SEQ / "img1")
    want = boxmot_tpu.Boxmot().track(source=SEQ / "img1")
    assert [len(r) for r in got] == [len(r) for r in want] == [0] * 8


def test_val_and_evaluate_equal_jax():
    for got, want in ((Boxmot(device="cpu").val(data=ROOTS["mot17_mini"]),
                       boxmot_tpu.Boxmot().val(data=ROOTS["mot17_mini"])),
                      (api.evaluate(ROOTS["mot17_mini"], device="cpu", postprocessing="gsi"),
                       boxmot_tpu.api.evaluate(ROOTS["mot17_mini"], postprocessing="gsi"))):
        for k in ("HOTA", "MOTA", "IDF1"):
            assert abs(got["combined"][k] - want["combined"][k]) <= ATOL, k
        assert list(got["per_seq"]) == list(want["per_seq"])
    res = Boxmot(device="cpu").val(data=ROOTS["mot17_mini"])
    for k, v in PINNED[("mot17_mini", "bytetrack")].items():
        assert abs(res["combined"][k] - v) <= ATOL


def test_train_equals_the_trainer_run_directly(tmp_path):
    from boxmot_tpu_torch.reid.training.trainer import ReIDTrainer, TrainConfig

    kw = dict(crop_hw=(64, 32), p=2, k=2, warmup_steps=1)
    res = Boxmot(reid="osnet_x0_25", device="cpu").train(
        data=REID_MINI, steps=2, ckpt_dir=tmp_path / "api", **kw)
    trainer = ReIDTrainer(TrainConfig(model="osnet_x0_25", data_root=str(REID_MINI), steps=2,
                                      ckpt_dir=str(tmp_path / "direct"), **kw), device="cpu")
    history = trainer.fit()
    assert res.steps == trainer.step == 2 and res.weights_path == str(tmp_path / "api")
    assert [h["loss"] for h in res.history] == [h["loss"] for h in history]
    assert res.final_loss == history[-1]["loss"] and "2 steps" in res.summary()


def test_eval_reid_is_the_port_evaluator(tmp_path):
    from boxmot_tpu_torch.reid import ReID
    from boxmot_tpu_torch.reid.datasets import load_dataset
    from boxmot_tpu_torch.reid.training.evaluator import evaluate_reid

    ds = load_dataset("market1501", REID_MINI)
    got = Boxmot(reid="osnet_x0_25", device="cpu").eval_reid(data=REID_MINI)
    assert got == evaluate_reid(ReID(model_name="osnet_x0_25", device="cpu").model, ds)
    weights = chip_smoke.reid_checkpoint(tmp_path, "osnet_x0_25", seed=3, crop_hw=(64, 32))
    got = Boxmot(reid=str(weights), device="cpu").eval_reid(data=REID_MINI, rerank=True)
    want = evaluate_reid(ReID(weights=weights, device="cpu").model, ds, rerank=True)
    assert got == want and 0.0 <= got["mAP"] <= 1.0


def test_unported_verbs_and_the_default_device(tmp_path):
    # export, refused until ROADMAP item 22, takes the JAX facade's arguments and
    # raises its ValueError on an unknown target
    from boxmot_tpu import api as jax_api

    bm = Boxmot(device="cpu")
    assert inspect.signature(Boxmot.export) == inspect.signature(jax_api.Boxmot.export)
    with pytest.raises(ValueError, match="unknown export target 'nosuch'"):
        bm.export(include=("nosuch",), out_dir=tmp_path, hw=(64, 32))
    assert set(n for n in dir(boxmot_tpu.api.Boxmot) if not n.startswith("_")) <= set(dir(Boxmot))
    for fn in (Boxmot.__init__, api.track, api.evaluate):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            Boxmot().track(source=SEQ)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            api.evaluate(ROOTS["mot17_mini"])

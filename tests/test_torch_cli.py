"""The port's CLI (``boxmot_tpu_torch.engine.cli``) against the JAX
package's, through ``click.testing.CliRunner`` with ``--device cpu``.

``eval`` gives the pins on MOT17-mini; with ``--benchmark mot17-mini``,
``--tuned <each tuned config>`` and ``--kf-noise`` it gives the metrics of the
JAX CLI's same command (read from the JAX ``run_eval`` it calls); with
``--benchmark mmot-mini`` the port's ``run_eval_obb`` values (held to JAX by
``chip_smoke.OBB_EVAL``). ``track --save-txt`` writes the JAX CLI's file
(ids and ``det_ind`` exact, boxes within 1e-4), ``tune-kf --out`` JAX's JSON
and ``generate`` JAX's caches; ``train`` and ``eval-reid`` run the port's
trainer and evaluator; ``export`` takes the JAX CLI's options and
``--device`` (``tune``, ``research``, ``build`` and ``export`` are held to
the JAX package in tests/test_torch_{tuning,research,native,export}.py).  A subprocess shows that the
CLI and the API load no module of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import chip_smoke
from boxmot_tpu.engine import cli as jcli_mod
from boxmot_tpu.engine import eval as jeval_mod
from boxmot_tpu_torch.configs import available_tuned_configs
from boxmot_tpu_torch.engine.cli import cli
from tests.test_pinned_metrics import PINNED, ROOTS

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
METRICS = ("HOTA", "MOTA", "IDF1")
SEQ = ROOTS["mot17_mini"] / "MOT17-04-FRCNN"


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


def port(*args):
    """The port's CLI in-process on the CPU; returns (result, its return value)."""
    res = CliRunner().invoke(cli, [*args, "--device", "cpu"] if args[0] != "tune-kf" else list(args),
                             standalone_mode=False)
    if res.exception is not None:
        raise res.exception
    return res, res.return_value


def jax_cli(monkeypatch, *args):
    """The JAX CLI's same command; returns (result, the metrics of the JAX
    ``run_eval`` it called, if any)."""
    calls = []
    real = jeval_mod.run_eval
    monkeypatch.setattr(jeval_mod, "run_eval", lambda *a, **k: calls.append(real(*a, **k))
                        or calls[-1])
    res = CliRunner().invoke(jcli_mod.cli, list(args))
    assert res.exit_code == 0, res.output
    return res, calls[-1] if calls else None


def metrics(res) -> dict:
    return {k: float(res["combined"][k]) for k in METRICS}


def assert_close(got, want):
    for k in METRICS:
        assert abs(got[k] - want[k]) <= ATOL, (k, got, want)


def test_eval_gives_the_pins(tmp_path):
    out, res = port("eval", "--data", str(ROOTS["mot17_mini"]), "--tracker", "bytetrack",
                    "--plots-dir", str(tmp_path / "plots"), "--no-rich")
    assert_close(metrics(res), PINNED[("mot17_mini", "bytetrack")])
    assert "COMBINED: HOTA 64.99  MOTA 49.53  IDF1 66.25" in out.output
    assert sorted(p.suffix for p in (tmp_path / "plots").iterdir()) == [".png", ".png"]


@pytest.mark.parametrize("extra", [
    ("--benchmark", "mot17-mini", "--kf-noise", "KF", "--postprocessing", "gsi"),
    *(("--data", str(ROOTS["mot17_mini"]), "--tracker", name.split("_")[0], "--tuned", name)
      for name in available_tuned_configs()),
], ids=["benchmark_kf_noise_gsi", *available_tuned_configs()])
def test_eval_options_give_the_jax_cli_metrics(extra, monkeypatch, tmp_path):
    if "KF" in extra:
        port("tune-kf", "--data", str(ROOTS["mot17_mini"]), "--tracker", "bytetrack", "--out",
             str(tmp_path / "kf.json"))
        extra = tuple(str(tmp_path / "kf.json") if a == "KF" else a for a in extra)
    out, got = port("eval", *extra, "--output-dir", str(tmp_path / "port"))
    jout, want = jax_cli(monkeypatch, "eval", *extra, "--output-dir", str(tmp_path / "jax"))
    assert_close(metrics(got), metrics(want))
    assert out.output.splitlines()[-1] == jout.output.splitlines()[-1]
    for p in (tmp_path / "jax").glob("*.txt"):
        assert (tmp_path / "port" / p.name).read_bytes() == p.read_bytes()


def test_eval_obb_benchmark_gives_the_held_values():
    out, res = port("eval", "--benchmark", "mmot-mini", "--tracker", "bytetrack")
    assert_close(metrics(res), chip_smoke.OBB_EVAL["bytetrack"])
    assert sorted(res["per_class"]) and out.output.splitlines()[-1].startswith("CLASS-AVERAGED:")


def _mot_file(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", ndmin=2)


def test_track_writes_the_jax_cli_file(monkeypatch, tmp_path):
    """``track --save-txt`` over MOT17-04's det.txt: the JAX CLI's rows (ids
    and det_ind exact, boxes within 1e-4); with ``--project`` the file goes
    into an incremented run dir, and ``--save-video`` writes every frame."""
    out, rows = port("track", "--source", str(SEQ), "--tracker", "ocsort",
                     "--save-txt", str(tmp_path / "port.txt"), "--show-timing")
    jax_cli(monkeypatch, "track", "--source", str(SEQ), "--tracker", "ocsort",
            "--save-txt", str(tmp_path / "jax.txt"))
    got, want = _mot_file(tmp_path / "port.txt"), _mot_file(tmp_path / "jax.txt")
    assert got.shape == want.shape and len(got) > 20
    exact = [0, 1, 7, 8]  # frame, id, cls, det_ind
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, 2:7], want[:, 2:7], atol=ATOL, rtol=0)
    assert rows.shape == (len(got), 9) and "wrote" in out.output
    for k in (1, 2):
        port("track", "--source", str(SEQ), "--project", str(tmp_path / "runs"))
        assert (tmp_path / "runs" / ("exp" if k == 1 else "exp2") / f"{SEQ.name}.txt").exists()
    port("track", "--source", str(SEQ), "--save-video", str(tmp_path / "v.mp4"))
    import cv2

    cap = cv2.VideoCapture(str(tmp_path / "v.mp4"))
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 8


def test_tune_kf_writes_the_jax_json(monkeypatch, tmp_path):
    for kw in (("--tracker", "ocsort"), ("--kf-type", "xyah", "--per-class")):
        port("tune-kf", "--data", str(ROOTS["mot17_mini"]), *kw, "--out", str(tmp_path / "p.json"))
        jax_cli(monkeypatch, "tune-kf", "--data", str(ROOTS["mot17_mini"]), *kw, "--out",
                str(tmp_path / "j.json"))
        assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_generate_writes_the_jax_caches(monkeypatch, tmp_path):
    port("generate", "--data", str(ROOTS["mot17_mini"]), "--cache-root", str(tmp_path / "port"))
    jax_cli(monkeypatch, "generate", "--data", str(ROOTS["mot17_mini"]), "--cache-root",
            str(tmp_path / "jax"))
    want = sorted((tmp_path / "jax").rglob("*.npy"))
    assert want
    for p in want:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / p.relative_to(tmp_path / "jax")),
                                      np.load(p))


def test_train_and_eval_reid_run_the_port(monkeypatch, tmp_path):
    """``train`` is the port's ReIDTrainer run directly (its metrics line),
    ``--recipe`` resolves to JAX's config, and ``eval-reid`` is the port's
    evaluator on ReID's seeded osnet_x0_25."""
    from boxmot_tpu.reid.training import trainer as jtrainer
    from boxmot_tpu_torch.reid import ReID
    from boxmot_tpu_torch.reid.datasets import load_dataset
    from boxmot_tpu_torch.reid.training import trainer as ttrainer
    from boxmot_tpu_torch.reid.training.evaluator import evaluate_reid

    data = str(REPO / "assets" / "reid-mini")
    out, _ = port("train", "--data", data, "--steps", "2", "--p", "2", "--k", "2",
                  "--ckpt-dir", str(tmp_path / "ckpt"))
    trainer = ttrainer.ReIDTrainer(ttrainer.TrainConfig(
        data_root=data, ckpt_dir=str(tmp_path / "direct"), steps=2, p=2, k=2), device="cpu")
    trainer.fit()
    r = trainer.evaluate()
    assert (f"rank-1 {100 * r['rank1']:.2f}  rank-5 {100 * r['rank5']:.2f}  "
            f"mAP {100 * r['mAP']:.2f}") in out.output

    seen = {}

    class Stop(Exception):
        pass

    def capture(key):
        def make(cfg, *a, **k):
            seen[key] = dataclasses.asdict(cfg)
            raise Stop
        return make

    monkeypatch.setattr(ttrainer, "ReIDTrainer", capture("port"))
    monkeypatch.setattr(jtrainer, "ReIDTrainer", capture("jax"))
    for recipe in ("osnet", "csl_tinyvit_7m"):
        args = ["train", "--data", data, "--recipe", recipe, "--lr", "0.001"]
        with pytest.raises(Stop):
            port(*args)
        CliRunner().invoke(jcli_mod.cli, args)
        common = seen["jax"].keys() & seen["port"].keys()
        assert {k: seen["port"][k] for k in common} == {k: seen["jax"][k] for k in common}
        assert seen["port"]["base_lr"] == 0.001
    out, res = port("eval-reid", "--data", data)
    want = evaluate_reid(ReID(model_name="osnet_x0_25", device="cpu").model,
                         load_dataset("market1501", data))
    assert res == want


@pytest.mark.parametrize("name,item", [("export", 22)])
def test_unported_commands_exit_naming_their_item(name, item, tmp_path):
    """``export``, refused until ROADMAP item 22, takes the JAX CLI's options
    and ``--device``; an unknown target exits non-zero naming the targets."""
    assert {p.name for p in cli.commands[name].params} == \
        {p.name for p in jcli_mod.cli.commands[name].params} | {"device"}
    res = CliRunner().invoke(cli, [name, "--include", "nosuch", "--imgsz", "64,32", "--out-dir",
                                   str(tmp_path), "--device", "cpu"])
    assert res.exit_code != 0 and "checkpoint,torch,saved_model,tflite,onnx" in res.output
    assert f"item {item}" not in res.output


def test_cli_and_api_leave_jax_out():
    """``python -m boxmot_tpu_torch.engine.cli eval`` prints the pins, and
    the API's ``track`` and ``val`` run, with no module of JAX or of the JAX
    package loaded."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['cli', 'eval', '--data', 'assets/MOT17-mini/train', '--tracker',\n"
        "            'bytetrack', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('boxmot_tpu_torch.engine.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "from boxmot_tpu_torch.api import Boxmot, evaluate, track\n"
        "bm = Boxmot(device='cpu')\n"
        "assert len(bm.track(source='assets/MOT17-mini/train/MOT17-02-FRCNN')) == 4\n"
        "assert abs(evaluate('assets/MOT17-mini/train', device='cpu')['combined']['HOTA']\n"
        "           - 0.649859) <= 1e-4\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'flax')\n"
        "       or m == 'boxmot_tpu' or m.startswith('boxmot_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "COMBINED: HOTA 64.99  MOTA 49.53  IDF1 66.25" in out.stdout

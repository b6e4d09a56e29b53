"""The port's ``:cpp`` backend (``boxmot_tpu_torch.native``) against the JAX
package's, on the CPU.

The native cores are host code in both packages, built once by cmake into
the repo's ``native/cpp/build/``.  The port's ``run_eval`` of
``bytetrack:cpp`` and ``occluboost:cpp`` gives the pins and JAX's ``:cpp``
rows exactly on MOT17-mini and synth-long, with 4 worker threads as
serially; its ``NativeTracker`` gives JAX's rows frame by frame for every
name of ``NATIVE_LIVE_TRACKERS`` (with embeddings where the core takes them,
and textured frames for the camera-motion cores), per class, on oriented
boxes and through OccluBoost's GTA flush; ``replay_cache_cpp`` writes JAX's
file.  Where the library cannot be built the port raises with cmake's
output, and the CLI's ``build`` prints what the JAX CLI prints.  A
subprocess shows that the ``:cpp`` paths load no module of JAX or of the
JAX package.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from boxmot_tpu.engine import eval as jeval
from boxmot_tpu.native import replay as jreplay
from boxmot_tpu.native import trackers as jtrackers
from boxmot_tpu_torch import native as tnative
from boxmot_tpu_torch.engine.eval import run_eval
from boxmot_tpu_torch.native import replay as treplay
from boxmot_tpu_torch.native import trackers as ttrackers
from tests.test_pinned_metrics import PINNED, ROOTS

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
METRICS = ("HOTA", "MOTA", "IDF1")
FEAT = 32


def _rows(out_dir: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.txt"))}


@pytest.mark.parametrize("root", ["mot17_mini", "synth_long"])
@pytest.mark.parametrize("tracker", ["bytetrack:cpp", "occluboost:cpp"])
def test_cpp_eval_gives_the_pins_and_jax_rows(root, tracker, tmp_path):
    got = run_eval(ROOTS[root], tracker, device="cpu", output_dir=tmp_path / "port")
    want = jeval.run_eval(ROOTS[root], tracker, output_dir=tmp_path / "jax")
    for k, v in PINNED[(root, tracker)].items():
        assert abs(got["combined"][k] - v) <= ATOL, (k, got["combined"][k], v)
        assert got["combined"][k] == want["combined"][k]
    assert _rows(tmp_path / "port") == _rows(tmp_path / "jax") != {}


def test_chip_smoke_cpp_pins_are_the_tests():
    import chip_smoke

    assert chip_smoke.CPP_PINNED == {t: PINNED[("mot17_mini", t)] for t in chip_smoke.CPP_PINNED}
    assert set(chip_smoke.CPP_PINNED) == {"bytetrack:cpp", "occluboost:cpp"}


def test_cpp_eval_thread_pool_equals_serial(tmp_path):
    seen = []
    pooled = run_eval(ROOTS["mot17_mini"], "bytetrack:cpp", device="cpu", n_workers=4,
                      output_dir=tmp_path / "pooled",
                      progress=lambda name, done, total: seen.append((name, done, total)))
    serial = run_eval(ROOTS["mot17_mini"], "bytetrack:cpp", device="cpu",
                      output_dir=tmp_path / "serial")
    assert {k: pooled["combined"][k] for k in METRICS} == \
        {k: serial["combined"][k] for k in METRICS}
    assert _rows(tmp_path / "pooled") == _rows(tmp_path / "serial")
    assert seen == [("MOT17-02-FRCNN", 1, 2), ("MOT17-04-FRCNN", 2, 2)]


def _scene(n_frames=30, seed=0, obb=False, n_classes=1):
    """Seeded moving boxes, some missed and some at low confidence, with
    unit embeddings and textured 240 x 320 frames of a panning camera."""
    rng = np.random.default_rng(seed)
    n = 7
    pos, vel = rng.uniform(40, 240, (n, 2)), rng.uniform(-3, 3, (n, 2))
    size, cls = rng.uniform(20, 50, (n, 2)), rng.integers(0, n_classes, n)
    ident = rng.normal(size=(n, FEAT))
    texture = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    frames = []
    for f in range(n_frames):
        keep = rng.uniform(size=n) > 0.15
        p = pos + vel * f + rng.normal(0, 1.0, (n, 2))
        conf = np.where(rng.uniform(size=n) < 0.25, rng.uniform(0.15, 0.4, n),
                        rng.uniform(0.5, 0.95, n))
        if obb:
            dets = np.column_stack([p, size, rng.uniform(-0.3, 0.3, n), conf, cls])
        else:
            dets = np.column_stack([p, p + size, conf, cls])
        embs = ident + 0.1 * rng.normal(size=(n, FEAT))
        embs /= np.linalg.norm(embs, axis=1, keepdims=True)
        img = np.ascontiguousarray(texture[f:f + 240, 2 * f:2 * f + 320])
        frames.append((dets[keep].astype(np.float32), embs[keep].astype(np.float32), img))
    return frames


def _same_rows(port_trk, jax_trk, frames, with_embs):
    n_rows = 0
    for f, (dets, embs, img) in enumerate(frames):
        e = embs if with_embs else None
        got = np.asarray(port_trk.update(dets, img, embs=e))
        want = np.asarray(jax_trk.update(dets, img, embs=e))
        np.testing.assert_array_equal(got, want, err_msg=f"frame {f}")
        n_rows += len(got)
    return n_rows


@pytest.mark.parametrize("name", jtrackers.NATIVE_LIVE_TRACKERS)
def test_native_tracker_equals_jax_frame_by_frame(name):
    """Every core, built from the zoo's defaults through ``create_tracker``,
    gives JAX's rows on every frame (with embeddings where the core takes
    them: its appearance path)."""
    from boxmot_tpu.trackers.zoo import create_tracker as jcreate
    from boxmot_tpu_torch.trackers.zoo import create_tracker

    assert ttrackers.NATIVE_LIVE_TRACKERS == jtrackers.NATIVE_LIVE_TRACKERS
    assert ttrackers._NATIVE_KEYS == jtrackers._NATIVE_KEYS
    # cores that would emit little on 30 frames confirm on their first hit
    params = {"ocsort": {"min_hits": 1}, "deepocsort": {"min_hits": 1},
              "hybridsort": {"min_hits": 1}, "strongsort": {"n_init": 1}}.get(name, {})
    port = create_tracker(f"{name}:cpp", device="cpu", **params)
    ref = jcreate(f"{name}:cpp", **params)
    assert type(port) is ttrackers.NativeTracker and port._cfg == ref._cfg
    with_embs = port.supports_embs
    assert _same_rows(port, ref, _scene(seed=len(name)), with_embs) > 0


def test_native_per_class_obb_and_gta_equal_jax():
    port = ttrackers.NativeTracker("bytetrack", per_class=True, device="cuda")
    ref = jtrackers.NativeTracker("bytetrack", per_class=True)
    assert _same_rows(port, ref, _scene(seed=3, n_classes=3), False) > 0
    for name in ("bytetrack", "ocsort", "sfsort"):
        port, ref = ttrackers.NativeTracker(name), jtrackers.NativeTracker(name)
        assert _same_rows(port, ref, _scene(seed=4, obb=True), False) > 0
        assert port.is_obb and ref.is_obb
    gta = {"gta_enabled": True, "max_age": 10, "gta_min_track_length": 3, "min_hits": 1}
    port = ttrackers.NativeTracker("occluboost", **gta)
    ref = jtrackers.NativeTracker("occluboost", **gta)
    _same_rows(port, ref, _scene(seed=5, n_frames=40), True)
    np.testing.assert_array_equal(port.flush_gta(), ref.flush_gta())
    port.reset()
    assert port.frame_count == 0 and len(port.update(None)) == 0
    with pytest.raises(ValueError, match="no native core"):
        ttrackers.NativeTracker("nosuch")
    warp = ttrackers.NativeECC().apply(_scene(n_frames=2)[1][2])
    np.testing.assert_array_equal(warp, jtrackers.NativeECC().apply(_scene(n_frames=2)[1][2]))


def test_replay_cache_cpp_equals_jax(tmp_path):
    from boxmot_tpu_torch.data.mot import MOTDataset

    dets = MOTDataset(ROOTS["mot17_mini"]).sequences[1].dets_per_frame()
    rows = [[f + 1, *r] for f, d in enumerate(dets) for r in d]
    cache = tmp_path / "dets.npy"
    np.save(cache, np.array(rows, np.float32).reshape(-1, 7))
    seen = {"port": [], "jax": []}
    kw = {"tracker_params": {"track_thresh": 0.5}, "seq_len": len(dets), "min_conf": 0.2}
    got = treplay.replay_cache_cpp("bytetrack", cache, tmp_path / "port.txt",
                                   progress=lambda *a: seen["port"].append(a), **kw)
    want = jreplay.replay_cache_cpp("bytetrack", cache, tmp_path / "jax.txt",
                                    progress=lambda *a: seen["jax"].append(a), **kw)
    assert got == want and got["frames"] == len(dets)
    assert seen["port"] == seen["jax"] != []
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert treplay.replay_executable_path() == jreplay.replay_executable_path()
    np.testing.assert_array_equal(
        treplay.replay_sequence_native("ocsort", dets, {"min_hits": 1}, frame_offset=2),
        jreplay.replay_sequence_native("ocsort", dets, {"min_hits": 1}, frame_offset=2))
    with pytest.raises(ValueError, match="no native core"):
        treplay.replay_cache_cpp("nosuch", cache, tmp_path / "x.txt")


def test_a_failed_build_raises_with_cmake_output(tmp_path, monkeypatch):
    """Where the JAX helper returns None, the port raises, and a ``:cpp``
    tracker never falls back to the device tracker."""
    from boxmot_tpu_torch.trackers.zoo import create_tracker

    broken = tmp_path / "cpp"
    (broken / "src").mkdir(parents=True)
    (broken / "CMakeLists.txt").write_text("cmake_minimum_required(VERSION 3.16)\n"
                                           "project(broken CXX)\nthis_is_not_a_command()\n")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_CPP_DIR", broken)
    monkeypatch.setattr(tnative, "_BUILD_DIR", broken / "build")
    with pytest.raises(RuntimeError, match="this_is_not_a_command"):
        tnative.get_library()
    with pytest.raises(RuntimeError, match="building the native library failed"):
        create_tracker("bytetrack:cpp", device="cpu")
    monkeypatch.setattr(tnative, "_CPP_DIR", tmp_path / "none")
    with pytest.raises(RuntimeError, match="not in this checkout"):
        tnative.get_library()
    monkeypatch.setenv("BOXMOT_TPU_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="BOXMOT_TPU_NO_NATIVE"):
        run_eval(ROOTS["mot17_mini"], "bytetrack:cpp", device="cpu")


def _echoed(output: str) -> list[str]:
    return [line for line in output.splitlines()
            if line.startswith(("native library", "rich:", "matplotlib:", "COMBINED:"))]


def test_cli_build_and_cpp_eval_print_what_the_jax_cli_prints(monkeypatch):
    from boxmot_tpu.engine.cli import cli as jcli
    from boxmot_tpu_torch.engine.cli import cli

    port = CliRunner().invoke(cli, ["build", "--device", "cpu"])
    want = CliRunner().invoke(jcli, ["build"])
    assert port.exit_code == 0 == want.exit_code, port.output
    assert _echoed(port.output) == _echoed(want.output) != []
    assert "torch device: cpu x1" in port.output
    args = ["eval", "--data", str(ROOTS["mot17_mini"]), "--tracker", "occluboost:cpp",
            "--n-workers", "4"]
    port = CliRunner().invoke(cli, [*args, "--device", "cpu"])
    want = CliRunner().invoke(jcli, args)
    assert port.exit_code == 0 == want.exit_code, port.output
    assert _echoed(port.output) == _echoed(want.output) and len(_echoed(port.output)) == 1
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setenv("BOXMOT_TPU_NO_NATIVE", "1")
    res = CliRunner().invoke(cli, ["build", "--device", "cpu"])
    assert res.exit_code != 0 and "native library unavailable" in res.output


def test_cpp_paths_leave_jax_out():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from boxmot_tpu_torch import create_tracker, run_eval\n"
        "res = run_eval('assets/MOT17-mini/train', 'bytetrack:cpp', device='cpu', n_workers=2)\n"
        "assert abs(res['combined']['HOTA'] - 0.649859) <= 1e-4\n"
        "trk = create_tracker('occluboost:cpp', device='cpu')\n"
        "assert trk.update(np.array([[1, 1, 20, 40, 0.9, 0]], np.float32)).shape == (1, 8)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'flax')\n"
        "       or m == 'boxmot_tpu' or m.startswith('boxmot_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr

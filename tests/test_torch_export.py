"""The port's ReID export (``reid/exporters.py``, ``models/flax_msgpack.py``)
and its checkpoint formats against the JAX package's, on the CPU, and the
export doors (``Boxmot.export``, ``cli export``).

Weights are random Flax variables made from a seed with numpy (the tree's
shapes from ``jax.eval_shape`` of the Flax ``init``; LeCun-scaled kernels,
scales and running variances in [0.5, 1.5]), carried into the port through
``models/convert.py::state_dict_from_flax_paths``.  Crops are 64 x 32.
``tests/test_torch_onnx.py`` and ``tests/test_torch_tflite.py`` use these
helpers.  Tolerances:

* Flax msgpack: the port's codec writes flax's bytes and reads them to the
  bit; the port's checkpoint loads in JAX, and JAX's in the port, to the
  bit; ``ReID`` and ``LiteYOLO`` built from a JAX-written ``.msgpack`` equal
  the same port model built from the carried variables, to the bit;
* torchreid ``.pt``: keys and arrays equal JAX's exporters' exactly;
* ``cli export`` of every target: each artifact reloaded through
  ``create_reid`` gives the source model's features (checkpoint and
  ``.pt`` to the bit, SavedModel and TFLite within 1e-4, the native
  runtime within 5e-3), the ONNX file its forward within 1e-5.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.models import clip_reid as jclip
from boxmot_tpu.models import convert as jconvert
from boxmot_tpu.reid import core as jcore
from boxmot_tpu.reid import exporters as jex
from boxmot_tpu_torch.models import clip_reid as tclip
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.models import flax_msgpack
from boxmot_tpu_torch.reid import ReID, create_reid
from boxmot_tpu_torch.reid import core as tcore
from boxmot_tpu_torch.reid import exporters as tex

REPO = Path(__file__).resolve().parent.parent
HW = (64, 32)
CLIP = {"width": 64, "layers": 2, "heads": 1, "proj_dim": 32}  # the narrow CLIP-ReID


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def flax_variables(jmodel, hw, seed: int) -> dict:
    """Seeded random Flax variables of ``jmodel`` as nested dicts of float32
    numpy arrays."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            return rng.normal(0, math.sqrt(1.0 / np.prod(shape[:-1])), shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


def carried(name: str, seed: int = 0):
    """(JAX module, its seeded variables, the port's module carrying them)."""
    if name == "clip":
        jmodel, model = jclip.ClipReID(**CLIP), tclip.ClipReID(crop_hw=HW, **CLIP)
    else:
        jmodel, model = jcore.MODEL_FACTORY[name](), tcore.build_model(name, HW)
    variables = flax_variables(jmodel, HW, seed)
    model.load_state_dict(tconvert.state_dict_from_flax_paths(model, name, variables))
    return jmodel, variables, model.eval()


def seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The port's ``model`` with LeCun-scaled seeded weights (numpy): what
    ``flax_variables`` draws, without JAX."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if not t.is_floating_point():
                continue
            if leaf in ("running_var",) or (leaf == "weight" and t.dim() == 1):
                a = rng.uniform(0.5, 1.5, t.shape)
            elif leaf == "weight" and t.dim() > 1:
                a = rng.normal(0, math.sqrt(1.0 / np.prod(t.shape[1:])), t.shape)
            else:
                a = rng.normal(0, 0.1, t.shape)
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model.eval()


def probe(seed=5, n=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, *HW, 3)).astype(np.float32)


def frame(seed=3, h=120, w=200):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


BOXES = np.array([[4.0, 6.0, 40.0, 80.0], [50.0, 10.0, 120.0, 90.0], [100, 20, 190, 110]],
                 np.float32)
OBBS = np.array([[40.0, 50.0, 30.0, 60.0, 0.3], [120.0, 60.0, 50.0, 70.0, -1.1]], np.float32)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def assert_trees_bit_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg="/".join(k))


def assert_state_bit_equal(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------- msgpack

def test_flax_msgpack_codec_writes_and_reads_flax_bytes():
    from flax import serialization

    _, variables, _ = carried("osnet_ain_x0_25")
    tree = {**variables, "misc": {"step": np.int64(7), "lr": np.float32(0.5), "n": 300,
                                  "neg": -40000, "f": 1.5, "none": None, "flag": True,
                                  "name": "x" * 40, "big": np.zeros((70000,), np.float32)}}
    want = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == want
    back = flax_msgpack.from_bytes(want)
    ref = serialization.msgpack_restore(want)
    assert_trees_bit_equal(back["params"], ref["params"])
    assert_trees_bit_equal(back["batch_stats"], ref["batch_stats"])
    for k, v in ref["misc"].items():
        assert type(back["misc"][k]) is type(v) and np.array_equal(back["misc"][k], v), k
    with pytest.raises(ValueError, match="after the msgpack object"):
        flax_msgpack.from_bytes(want + b"\x00")


@pytest.mark.parametrize("name", ["osnet_x0_25", "osnet_ain_x0_25", "lmbn_n", "vit_nano"])
def test_checkpoint_round_trips_both_ways(name, tmp_path):
    """The port's ``.msgpack`` loads in JAX (``from_bytes`` checks the tree's
    keys against the template's) equal to the carried variables, and JAX's
    loads into a fresh port model equal to the carried one, to the bit."""
    _, variables, model = carried(name)
    path = tex.export_checkpoint(model, name, tmp_path / f"{name}.msgpack")
    assert_trees_bit_equal(jex.load_checkpoint(variables, path), variables)
    jpath = jex.export_checkpoint(variables, tmp_path / f"jax_{name}.msgpack")
    fresh = tex.load_checkpoint(tcore.build_model(name, HW), name, jpath)
    assert_state_bit_equal(fresh, model)
    assert_trees_bit_equal(tex.flax_variables(fresh, name), variables)


def test_reid_and_liteyolo_load_a_jax_msgpack(tmp_path):
    from boxmot_tpu.detectors import yolo_lite as jyl

    from boxmot_tpu_torch.detectors.yolo_lite import LiteYOLO

    _, variables, model = carried("osnet_x0_25")
    path = jex.export_checkpoint(variables, tmp_path / "osnet_x0_25_market.msgpack")
    reid = ReID(weights=path, device="cpu", crop_hw=HW)
    ref = ReID(model_name="osnet_x0_25", device="cpu", crop_hw=HW)
    ref.model.load_state_dict(model.state_dict())
    assert_state_bit_equal(reid.model, ref.model)
    img = frame()
    np.testing.assert_array_equal(reid.get_features(BOXES, img), ref.get_features(BOXES, img))
    assert isinstance(create_reid(path, device="cpu", crop_hw=HW), ReID)
    # as in JAX, a .msgpack that does not exist gives the name's seeded model
    assert_state_bit_equal(ReID(weights=tmp_path / "osnet_x0_25.msgpack", device="cpu").model,
                           ReID(model_name="osnet_x0_25", device="cpu").model)

    lite_vars = flax_variables(jyl._build("segment", 3), (jyl.IMGSZ, jyl.IMGSZ), seed=4)
    lpath = tmp_path / "yololite-seg.msgpack"
    from flax import serialization

    lpath.write_bytes(serialization.to_bytes(lite_vars))
    lite = LiteYOLO(lpath, device="cpu")
    want = LiteYOLO("yololite-seg.pt", device="cpu")
    want.model.load_state_dict(tconvert.yololite_state_dict_from_flax(lite_vars, "segment"))
    assert_state_bit_equal(lite.model, want.model)
    img = frame(9, 180, 320)
    got, ref = lite(img, conf=0.05)[0], want(img, conf=0.05)[0]
    assert len(got.boxes) == len(ref.boxes)
    np.testing.assert_array_equal(got.boxes.xyxy, ref.boxes.xyxy)
    np.testing.assert_array_equal(got.masks.data, ref.masks.data)


@pytest.mark.parametrize("name", ["osnet_x0_25", "osnet_ibn_x1_0", "osnet_ain_x0_25"])
def test_torch_state_dict_equals_jax(name, tmp_path):
    """The port's ``.pt`` holds JAX's exporters' keys and arrays exactly
    (``export_torch_state_dict`` for the plain variants; JAX's IBN and AIN
    exporters for those), and reloads to the bit."""
    _, variables, model = carried(name)
    path = tex.export_torch_state_dict(model, name, tmp_path / f"{name}.pt")
    got = torch.load(path, weights_only=False)["state_dict"]
    if name.startswith("osnet_ain"):
        want = jconvert.export_osnet_ain_state_dict(variables)
    elif name.startswith("osnet_ibn"):
        want = jconvert.export_osnet_state_dict(variables, ibn=True)
    else:
        jpath = jex.export_torch_state_dict(variables, tmp_path / "jax.pt")
        want = torch.load(jpath, weights_only=False)["state_dict"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert_state_bit_equal(ReID(weights=path, device="cpu", crop_hw=HW).model, model)
    with pytest.raises(ValueError, match="OSNet family"):
        tex.export_torch_state_dict(tcore.build_model("resnet50"), "resnet50", tmp_path / "r.pt")


# ------------------------------------------------------- the API and the CLI

def test_api_export(tmp_path):
    from boxmot_tpu_torch.api import Boxmot

    res = Boxmot(reid="osnet_x0_25", device="cpu").export(include=("checkpoint", "onnx"),
                                                           out_dir=tmp_path, hw=HW)
    assert type(res).__name__ == "ExportResult" and set(res) == {"checkpoint", "onnx"}
    assert res["onnx"]["max_dev"] < 5e-3 and "osnet_x0_25.onnx" in res.summary()
    src = ReID(model_name="osnet_x0_25", device="cpu", crop_hw=HW)
    assert_state_bit_equal(create_reid(res["checkpoint"]["path"], device="cpu", crop_hw=HW).model,
                           src.model)
    with pytest.raises(ValueError, match="unknown export target"):
        Boxmot(device="cpu").export(include=("nosuch",), out_dir=tmp_path, hw=HW)


def test_cli_export_every_target_without_jax(tmp_path):
    """``cli export`` of every target in a subprocess that loads no module of
    the JAX package, with JAX and flax hidden (so that importing either
    raises, as on the card's machine, which has neither: TensorFlow's TFLite
    helpers import JAX wherever it is installed); each artifact reloads
    through ``create_reid`` (and the ONNX file through the evaluator) and
    gives the source model's features, and so do the native runtime and
    ``sharded_reid_features``."""
    code = (
        "import sys\n"
        "sys.modules.update(jax=None, jaxlib=None, flax=None)  # as on the card's machine\n"
        "import numpy as np\n"
        "from boxmot_tpu_torch.engine.cli import cli\n"
        f"out = {str(tmp_path)!r}\n"
        "arts = cli.main(['export', '--include', 'checkpoint,torch,onnx,saved_model,tflite',\n"
        "             '--imgsz', '64,32', '--out-dir', out, '--device', 'cpu'],\n"
        "            standalone_mode=False)\n"
        "from boxmot_tpu_torch.reid import ReID, create_reid\n"
        "from boxmot_tpu_torch.reid.exporters import run_onnx_export\n"
        "rng = np.random.default_rng(3)\n"
        "img = rng.integers(0, 256, (120, 200, 3), dtype=np.uint8)\n"
        "boxes = np.array([[4, 6, 40, 80], [50, 10, 120, 90]], np.float32)\n"
        "src = ReID(model_name='osnet_x0_25', device='cpu', crop_hw=(64, 32))\n"
        "want = src.get_features(boxes, img)\n"
        "assert all(arts[t]['seconds'] > 0 for t in arts)\n"
        "feats = {t: create_reid(arts[t]['path'], device='cpu', crop_hw=(64, 32)).get_features(\n"
        "    boxes, img) for t in ('checkpoint', 'torch', 'saved_model', 'tflite')}\n"
        "x = rng.uniform(-1, 1, (1, 64, 32, 3)).astype(np.float32)\n"
        "from boxmot_tpu_torch.reid.exporters import forward_nhwc\n"
        "feats['onnx'] = run_onnx_export(arts['onnx']['path'], x) - forward_nhwc(src.model, x)\n"
        "from boxmot_tpu_torch.native.reid import export_native_reid\n"
        "manifest = export_native_reid('osnet_x0_25', src.model, out + '/native', (64, 32))\n"
        "feats['native'] = create_reid(manifest).get_features(boxes, img)\n"
        "import torch\n"
        "from boxmot_tpu_torch.parallel.replay import sharded_reid_features\n"
        "crops = rng.uniform(-2, 2, (3, 64, 32, 3)).astype(np.float32)\n"
        "feats['sharded'] = sharded_reid_features(src, crops, [torch.device('cpu')] * 2) - \\\n"
        "    src._embed(torch.from_numpy(crops).permute(0, 3, 1, 2)).numpy()\n"
        "np.savez(out + '/feats.npz', want=want, **feats)\n"
        "bad = [m for m in sys.modules if m == 'boxmot_tpu' or m.startswith('boxmot_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "tflite max |diff| vs cpu" in out.stdout and "onnx max |diff| vs cpu" in out.stdout
    feats = np.load(tmp_path / "feats.npz")
    for t in ("checkpoint", "torch"):
        np.testing.assert_array_equal(feats[t], feats["want"])
    for t in ("saved_model", "tflite"):
        np.testing.assert_allclose(feats[t], feats["want"], rtol=0, atol=1e-4)
    assert np.abs(feats["onnx"]).max() < 1e-5 and np.abs(feats["sharded"]).max() < 1e-6
    np.testing.assert_allclose(feats["native"], feats["want"], rtol=0, atol=5e-3)

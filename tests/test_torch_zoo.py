"""The port's tracker zoo against the JAX package's: YAML configs given by
path, and the ``name:backend`` spec and ``backend=`` argument (on the CPU).

The tuned overlays under ``boxmot_tpu/configs/trackers/tuned/`` hold only
changed values, not specs; the zoo reads the full tracker YAMLs.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import boxmot_tpu
from boxmot_tpu.configs import flatten_config as jax_flatten
from boxmot_tpu_torch import create_tracker
from boxmot_tpu_torch.configs import flatten_config, get_tracker_defaults, load_tracker_yaml
from boxmot_tpu_torch.trackers.zoo import parse_tracker_spec

REPO = Path(__file__).resolve().parent.parent
YAMLS = sorted((REPO / "boxmot_tpu" / "configs" / "trackers").glob("*.yaml"))


def _settings(tracker, params):
    """What a built tracker was configured with: its config, or (sam2mot, a
    host tracker) the attributes named by the YAML's params."""
    if hasattr(tracker, "cfg"):
        return dataclasses.asdict(tracker.cfg)
    return {k: getattr(tracker, k) for k in params if hasattr(tracker, k)}


def test_every_tracker_yaml_is_read():
    assert len(YAMLS) == 10


@pytest.mark.parametrize("path", YAMLS, ids=[p.stem for p in YAMLS])
def test_yaml_path_gives_the_jax_params(path):
    """``create_tracker(name, tracker_config=<yaml path>)`` reads and flattens
    the file as the JAX zoo does; the tracker gets the same params, from the
    JAX file and from the port's own copy of it."""
    name = path.stem
    with open(path) as f:
        specs = yaml.safe_load(f)
    want = jax_flatten(specs)
    assert flatten_config(specs) == want == load_tracker_yaml(path)
    assert load_tracker_yaml(str(path)) == get_tracker_defaults(name)  # the written-out tier
    copy = REPO / "boxmot_tpu_torch" / "configs" / "trackers" / path.name
    assert load_tracker_yaml(copy) == want
    ref = boxmot_tpu.create_tracker(name, tracker_config=str(path))
    for yaml_path in (path, copy):
        got = create_tracker(name, device="cpu", tracker_config=yaml_path)
        assert type(got).__name__ == type(ref).__name__
        assert _settings(got, want) == _settings(ref, want) != {}
    tweaked = create_tracker(name, device="cpu", tracker_config=str(path),
                             evolve_param_dict={"max_age": 7} if "max_age" in want else None)
    assert type(tweaked) is type(got)


def test_specs_and_backends():
    """"name:tpu" and backend="tpu" give the device tracker; "cpp" gives the
    native core (``NativeTracker``, host code, its config string the JAX
    zoo's); an unknown backend raises ValueError, in the spec or as
    ``backend``; ``backend`` wins over the spec's, as in the JAX zoo."""
    from boxmot_tpu_torch.native.trackers import NativeTracker

    assert parse_tracker_spec("ocsort") == ("ocsort", "tpu")
    assert parse_tracker_spec("ocsort:cpp") == ("ocsort", "cpp")
    for kw in ({"tracker_type": "bytetrack:tpu"}, {"tracker_type": "bytetrack", "backend": "tpu"},
               {"tracker_type": "bytetrack:cpp", "backend": "tpu"}):
        assert type(create_tracker(device="cpu", **kw)).__name__ == "ByteTrack"
    for kw in ({"tracker_type": "bytetrack:cpp"}, {"tracker_type": "ocsort", "backend": "cpp"},
               {"tracker_type": "ocsort:tpu", "backend": "cpp"}):
        got = create_tracker(device="cpu", **kw)
        want = boxmot_tpu.create_tracker(**kw)
        assert type(got) is NativeTracker and got._cfg == want._cfg
        assert got.tracker_type == want.tracker_type == kw["tracker_type"].split(":")[0]
    with pytest.raises(ValueError, match="unknown tracker backend"):
        create_tracker("bytetrack:gpu", device="cpu")
    with pytest.raises(ValueError, match="unknown tracker backend"):
        create_tracker("bytetrack", device="cpu", backend="gpu")
    with pytest.raises(ValueError, match="unknown tracker backend"):
        boxmot_tpu.create_tracker("bytetrack:gpu")
    with pytest.raises(ValueError, match="Unknown tracker"):
        create_tracker("nosuch:tpu", device="cpu")
    out = create_tracker("bytetrack:tpu", device="cpu").update(
        np.array([[10, 10, 50, 90, 0.9, 0]], np.float32), np.zeros((100, 100, 3), np.uint8))
    assert out.shape[1] == 8


def test_missing_yaml_raises_a_clear_error():
    """Without PyYAML a YAML path raises ImportError naming the way out; the
    default path never imports yaml."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"  # importing yaml now raises ImportError
        "import boxmot_tpu_torch\n"
        "boxmot_tpu_torch.create_tracker('bytetrack', device='cpu')\n"
        "try:\n"
        "    boxmot_tpu_torch.create_tracker('bytetrack', device='cpu',\n"
        "                                    tracker_config='boxmot_tpu/configs/trackers/bytetrack.yaml')\n"
        "except ImportError as e:\n"
        "    assert 'PyYAML' in str(e) and 'tracker_config={...}' in str(e), e\n"
        "    print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

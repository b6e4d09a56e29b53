"""Small path / CLI / device utilities.

A copy of ``boxmot_tpu/utils/misc.py`` (the reference's
boxmot/utils/misc.py:13-149 and torch_utils.py:12-50), but for its two
device functions, which report and resolve PyTorch's devices where the JAX
module asks JAX: ``get_system_info`` names torch, CUDA and the card, and
``select_device`` gives a ``torch.device``, the card for an empty spec, and
raises when CUDA is asked for and absent instead of giving the CPU.
"""

from __future__ import annotations

import sys
import threading
from pathlib import Path

from boxmot_tpu_torch.utils.logging import LOGGER

WEIGHTS_DIR = Path("models")


def parse_imgsz(value):
    """Normalize an image-size spec: int / "640" -> 640 (square),
    "H,W" or "H W" or a 2-sequence -> (H, W).  None passes through."""
    if value is None:
        return None
    if isinstance(value, int):
        return value
    if isinstance(value, (tuple, list)):
        vals = [int(v) for v in value]
    else:
        vals = [int(p) for p in str(value).replace(",", " ").split()]
    if len(vals) == 1:
        return vals[0]
    if len(vals) == 2:
        return (vals[0], vals[1])
    raise ValueError(f"invalid imgsz spec: {value!r} (want N or H,W)")


def resolve_model_path(model_path, default_dir: Path = WEIGHTS_DIR) -> Path:
    """Keep explicit paths as-is; fall back to the weights directory for
    bare file names; resolve case-insensitive sibling matches."""
    path = Path(model_path)
    candidates = [path]
    if not path.is_absolute() and path.parent == Path("."):
        candidates.append(Path(default_dir) / path.name)
    for cand in candidates:
        if cand.exists():
            return cand
    for cand in candidates:
        if not cand.parent.exists():
            continue
        wanted = cand.name.lower()
        for sibling in cand.parent.iterdir():
            if sibling.name.lower() == wanted:
                return sibling
    return candidates[-1]


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/exp -> runs/exp2 -> runs/exp3 ... (files keep their suffix)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        if path.is_file():
            base, suffix = str(path.with_suffix("")), path.suffix
        else:
            base, suffix = str(path), ""
        for n in range(2, 9999):
            cand = Path(f"{base}{sep}{n}{suffix}")
            if not cand.exists():
                path = cand
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def prompt_overwrite(path_type: str, path, ci: bool = True, timeout: float = 3.0) -> bool:
    """Ask whether to overwrite an existing artifact; non-interactive runs
    (ci=True or no TTY) reuse the existing file without prompting."""
    if ci or not sys.stdin.isatty():
        LOGGER.debug(f"{path_type} {path} already exists; reusing (non-interactive).")
        return False

    print(f"{path_type} {path} already exists. Overwrite? [y/N] ", end="", flush=True)
    answer = []
    got = threading.Event()

    def _read():
        answer.append(sys.stdin.readline().strip().lower())
        got.set()

    t = threading.Thread(target=_read, daemon=True)
    t.start()
    t.join(timeout)
    if not got.is_set():
        print("\nNo response; keeping the existing file.")
        return False
    return answer[0] in ("y", "yes")


def get_system_info() -> dict:
    """Platform + accelerator report (torch_utils.py:12 equivalent): the
    torch version, its CUDA version, and the cards torch sees."""
    import platform

    import torch

    info = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info.update(
        backend="cuda" if n else "cpu",
        device_kind=torch.cuda.get_device_name(0) if n else "cpu",
        n_devices=n,
    )
    return info


def select_device(device: str = ""):
    """Resolve a device spec to a ``torch.device`` (torch_utils.select_device
    equivalent): "" -> the first card, "cpu" -> the CPU, "cuda" / "cuda:1"
    / "1" -> that card.  Raises when a card is asked for and CUDA is
    absent; never gives the CPU in its place."""
    from boxmot_tpu_torch.utils.device import resolve_device

    spec = str(device).strip().lower()
    if not spec:
        spec = "cuda:0"
    elif spec.isdigit():
        spec = f"cuda:{spec}"
    return resolve_device(spec)

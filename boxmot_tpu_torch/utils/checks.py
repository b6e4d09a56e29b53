"""A copy of ``boxmot_tpu/utils/checks.py``.

Optional-dependency checking.

Mirror of the reference RequirementsChecker (boxmot/utils/checks.py:19-213)
minus the runtime ``uv pip install`` path: this framework is built for
hermetic, zero-egress deployment, so missing extras produce a single
actionable error instead of a mid-run installer.  An opt-in install
attempt is kept for development machines.
"""

from __future__ import annotations

import importlib.metadata
import importlib.util
import re
import subprocess
import sys
from typing import Iterable, Sequence

from boxmot_tpu_torch.utils.logging import LOGGER as logger

# requirement name -> import name, where they differ
_IMPORT_ALIASES = {
    "opencv-python": "cv2",
    "pillow": "PIL",
    "pyyaml": "yaml",
    "scikit-learn": "sklearn",
}

_REQ_RE = re.compile(r"^([A-Za-z0-9_.\-]+)")


def requirement_satisfied(requirement: str) -> bool:
    """True when the distribution (or importable module) is present.

    Version pins are checked only for presence of the distribution —
    hermetic images either have the right pin or fail loudly at import.
    """
    m = _REQ_RE.match(requirement.strip())
    if not m:
        return False
    name = m.group(1)
    try:
        importlib.metadata.version(name)
        return True
    except importlib.metadata.PackageNotFoundError:
        pass
    module = _IMPORT_ALIASES.get(name.lower(), name.replace("-", "_"))
    return importlib.util.find_spec(module) is not None


def missing_requirements(requirements: Iterable[str]) -> list[str]:
    return [r for r in requirements if not requirement_satisfied(r)]


class RequirementsChecker:
    """Check (and optionally install) extras for a subsystem.

    ``check_packages`` is the hot path: it never touches the network.
    ``sync_extra`` names a pyproject extra in diagnostics so users get
    the same guidance the reference's installer printed.
    """

    def __init__(self, allow_install: bool = False):
        self.allow_install = allow_install

    def check_packages(
        self, requirements: Sequence[str], purpose: str = ""
    ) -> None:
        missing = missing_requirements(requirements)
        if not missing:
            return
        if self.allow_install and self._install(missing):
            still = missing_requirements(missing)
            if not still:
                return
            missing = still
        ctx = f" for {purpose}" if purpose else ""
        raise ModuleNotFoundError(
            f"missing optional dependencies{ctx}: {', '.join(missing)}. "
            f"Install them into the image (pip install {' '.join(missing)}) "
            "— runtime installs are disabled in hermetic deployments."
        )

    def sync_extra(self, extra: str, requirements: Sequence[str]) -> None:
        try:
            self.check_packages(requirements, purpose=f"extra [{extra}]")
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                f"{e} (equivalent: pip install 'boxmot-tpu[{extra}]')"
            ) from None

    def _install(self, packages: Sequence[str]) -> bool:
        cmd = [sys.executable, "-m", "pip", "install", "--no-input", *packages]
        logger.info(f"installing missing extras: {' '.join(packages)}")
        try:
            out = subprocess.run(
                cmd, capture_output=True, text=True, timeout=600
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            logger.warning(f"install failed: {e}")
            return False
        if out.returncode != 0:
            logger.warning(f"install failed: {out.stderr.strip()[-500:]}")
            return False
        return True

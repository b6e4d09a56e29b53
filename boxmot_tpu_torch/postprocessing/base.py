"""A copy of ``boxmot_tpu/postprocessing/base.py``.

Postprocessor base classes (mirror of boxmot/postprocessing/base.py).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path


class Postprocessor(ABC):
    """Array-level postprocessor."""

    name = "base"

    @abstractmethod
    def __call__(self, rows):
        """Transform (N, >=9) MOT rows and return the new array."""

    def run(self, mot_results_folder: Path):
        for path in sorted(Path(mot_results_folder).glob("*.txt")):
            self.process_file(path)


class MotFilePostprocessor(Postprocessor):
    """Processes each MOT result txt file in place."""

    def process_file(self, path: Path):
        import numpy as np

        try:
            rows = np.loadtxt(path, delimiter=",", ndmin=2)
        except (ValueError, OSError):
            return
        if rows.size == 0:
            return
        out = self(rows)
        np.savetxt(path, out, fmt="%d,%d,%d,%d,%d,%d,%.6f,%d,%d")

"""Framework logger + output-suppression context (a copy of
boxmot_tpu/utils/logging.py, with the port's logger name).

Light mirror of the reference logging surface (boxmot/utils/__init__.py:
47-66 loguru LOGGER with per-process filters; utils/misc.py:149
suppression context) on the standard library: one shared `LOGGER`, a
`set_verbosity` switch, and `suppress_output()` to silence noisy
third-party imports (TF/absl) around export and conversion code.  Unlike
the JAX package's, the logger adds no handler of its own and keeps
propagating to the root logger: the port's trackers log through the same
"boxmot_tpu_torch" logger, and their warnings must reach the handlers the
application (or pytest's log capture) installs.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys

LOGGER = logging.getLogger("boxmot_tpu_torch")


def set_verbosity(verbose: bool) -> None:
    LOGGER.setLevel(logging.DEBUG if verbose else logging.INFO)


@contextlib.contextmanager
def suppress_output(stdout: bool = True, stderr: bool = True):
    """Redirect stdout/stderr to devnull for the block (misc.py:149)."""
    with open(os.devnull, "w") as devnull:
        old_out, old_err = sys.stdout, sys.stderr
        try:
            if stdout:
                sys.stdout = devnull
            if stderr:
                sys.stderr = devnull
            yield
        finally:
            sys.stdout, sys.stderr = old_out, old_err

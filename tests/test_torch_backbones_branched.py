"""LMBN, LMBN-AIN and HACNN of the port against the JAX package's Flax
models, on the CPU, as ``tests/test_torch_backbones.py`` holds the other
backbones (its seeded variables, crop sizes and tolerance): apart, so that
their JAX compiles (about 10 s each) run beside the others'.
"""

from __future__ import annotations

import pytest

from tests.test_torch_backbones import BRANCHED, _one_thread, assert_equals_flax  # noqa: F401


@pytest.mark.parametrize("name", BRANCHED)
def test_branched_backbone_equals_flax(name):
    assert_equals_flax(name)

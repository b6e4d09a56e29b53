"""Geometry, IoU, and the two hand-written kernels with their plain twins."""

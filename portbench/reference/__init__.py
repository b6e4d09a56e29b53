"""The plain reference: plain PyTorch, NumPy and (for the letterbox) OpenCV,
with frozen copies of the port's model definitions and plain (twin) paths
under ``frozen/``.  It imports nothing of the port, of the JAX package or of
JAX, and works its results out again from the inputs that the benchmark
hands both sides."""

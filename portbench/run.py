"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``boxmot_tpu_torch/``, on a machine with an NVIDIA card.  The last line
of standard output is the result (see ``harness.py``).  Build and kernel
caches are kept in fixed directories inside the checkout, set here before
torch is imported.  A run keeps to the first four CPUs it may use, with as
many threads, so that its host work does not wander between cores.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
# a library that the port may load must not load JAX, Flax or TensorFlow by itself
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    CPUS = sorted(os.sched_getaffinity(0))[:4]
    os.sched_setaffinity(0, CPUS)
    os.environ["OMP_NUM_THREADS"] = str(len(CPUS))
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START, ROOT))

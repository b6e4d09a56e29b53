"""A copy of ``boxmot_tpu/configs/benchmark.py``.

Benchmark runtime configs (configs/benchmarks/*.yaml).

Mirror of the reference benchmark binding (boxmot/data/benchmark.py:106
+ configs/benchmark.py): each YAML names the dataset layout, split
roots, class/distractor maps and the detector/reid ids whose caches feed
replay.
"""

from __future__ import annotations

from pathlib import Path

import yaml

BENCHMARK_DIR = Path(__file__).parent / "benchmarks"


def available_benchmarks() -> tuple[str, ...]:
    return tuple(sorted(p.stem for p in BENCHMARK_DIR.glob("*.yaml")))


def load_benchmark(name: str) -> dict:
    path = BENCHMARK_DIR / f"{name}.yaml"
    if not path.exists():
        raise ValueError(
            f"unknown benchmark {name!r}; available: {available_benchmarks()}"
        )
    with open(path) as f:
        return yaml.safe_load(f)


def resolve_split_dir(cfg: dict, split: str | None = None, repo_root: Path | None = None) -> Path:
    ds = cfg["dataset"]
    split = split or ds.get("default_split")
    rel = Path(ds["root"]) / ds["splits"][split]
    root = repo_root or Path(__file__).resolve().parents[2]
    return root / rel

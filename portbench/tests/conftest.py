"""Cells of ``BENCHMARK.json`` and ``parked.json`` cut to sizes that the CPU runs in seconds:
the same drivers, program paths and reference, on smaller inputs."""

import copy
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
LIVE = "occluboost.live-720p"
REPLAY = "hybridsort.replay-sportsmot-val"


def small_cell(name: str) -> harness.Cell:
    cell = harness.Cell(ROOT, harness.load_bench(ROOT, parked=True), name)
    cell.config, cell.traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if name == LIVE:
        cell.config["detector"].update(name="yolox_s", imgsz=[160, 288])
        cell.config["reid"]["crop_hw"] = [64, 32]
        cell.traffic["params"]["pool_frames"] = 4
        cell.traffic.update(warmup_frames=1, track_check_frames=6)
    else:
        cell.config["tracker"]["params"]["longterm_bank_length"] = 30
        cell.traffic["params"].update(sequences=3, frames=24)
    return cell


def drive(name: str, seed: int, device="cpu", frames: int = 6, fault=None):
    """Set-up, a window of ``frames`` frames (live) or one call (replay), and
    the check of a small cell; ``fault(run)``, where given, breaks the timed
    path after set-up.  Returns (correct, numbers, run)."""
    cell = small_cell(name)
    run = harness.load_driver(cell.traffic["kind"]).Run(cell, seed, torch.device(device))
    run.setup()
    if fault is not None:
        fault(run)
    run.window(0.0 if name == REPLAY else -1.0)
    if name == LIVE:
        while len(run.rows) < frames:
            run._frame(len(run.rows))
        run.attempted = len(run.rows)
    run.release()
    numbers = run.check()
    correct, _ = harness.decide(numbers, cell.limits)
    return correct, numbers, run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels and TF32 have no CPU mode")
    return torch.device("cuda")

"""What every run shares: the spec files, the run's context, the device's
description, the check for modules that must not be loaded."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffpose_tpu")


class NoDevice(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_file(path: Path, name: str):
    """A module from a file (names under ``metrics/`` hold dots)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = module
    mod_spec.loader.exec_module(module)
    return module


@dataclass
class Ctx:
    """One run of one cell."""

    name: str
    cell: dict                 # the workload's file
    config: dict               # the configuration's file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    kernel_precision: str      # the configuration's, or the control's

    @property
    def runner_seed(self) -> int:
        """The program's own seed (loader order, per-sample ids, draws):
        the run's seed folded into the range of the program's command line."""
        return self.seed % (1 << 31)


@dataclass
class Run:
    """What the per-layer readers see after the window."""

    ctx: Ctx
    session: Any
    window_s: float
    frames: int
    units: int                 # batches or steps in the window
    slice: Optional[Any]       # harness.trace.Slice


def forbidden_modules(names=None) -> list:
    """Which of :data:`FORBIDDEN` are loaded, by whole top-level name (so
    ``diffpose_tpu_torch`` is not ``diffpose_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                            f"--id={device.index or 0}"], capture_output=True, text=True,
                           timeout=30)
        info["power_limit"] = q.stdout.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "not read"
    return info

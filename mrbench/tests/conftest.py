"""Shared pieces of the harness's CPU tests: a stand-in for the card that
runs the program on the CPU, and the cells at sizes a test can hold.

Run with ``python -m pytest mrbench/tests`` from the repository root."""

from __future__ import annotations

import copy
import json
import pathlib
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


class HostCard:
    """The chip seam on the CPU: the program's jobs and the generators run
    on the CPU, there is no device memory and no device trace."""

    platform = "cpu"
    device = "cpu"
    generator_device = "cpu"
    kind = "cpu"

    def __init__(self, count: int = 1) -> None:
        self.count = count

    def synchronize(self) -> None:
        pass

    def reset_peak(self) -> None:
        pass

    def memory_peak(self) -> int:
        return 0

    def profiler_activities(self) -> list:
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU]

    def mark(self) -> float:
        return time.perf_counter()

    def power_limit(self) -> str:
        return "cpu"


#: Sizes a CPU test run holds, per traffic mix: small jobs, a small
#: merge capacity and chunks (so a job still spans several chunks).
TINY_TRAFFIC = {
    "64m": {"job_bytes": {"law": "fixed", "bytes": 96 << 10}, "pool_files": 3,
            "warmup_bytes": 40 << 10},
    "256m": {"job_bytes": {"law": "fixed", "bytes": 128 << 10}, "pool_files": 2,
             "warmup_bytes": 40 << 10},
}
TINY_PROGRAM = {"chunk_bytes": 32 << 10, "merge_capacity": 1 << 14}
TINY_ZIPF_RANKS = 1 << 14


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def tiny(config: dict, traffic_name: str) -> tuple[dict, dict]:
    """(configuration, traffic) of a cell at a CPU test's size."""
    config = copy.deepcopy(config)
    config["program"].update(TINY_PROGRAM)
    if config["generator"] == "zipf":
        config["generator_params"]["ranks"] = TINY_ZIPF_RANKS
    return config, dict(TINY_TRAFFIC[traffic_name])


def write_tiny_root(dest: pathlib.Path) -> None:
    """A checkout root holding BENCHMARK.json and the data files of every
    cell at a test's size (the code still comes from the mrbench package)."""
    b = bench()
    (dest / "mrbench" / "configs").mkdir(parents=True)
    (dest / "mrbench" / "traffic").mkdir(parents=True)
    for c in b["configs"]:
        with open(ROOT / c["file"]) as f:
            config = json.load(f)
        config, _ = tiny(config, "64m")
        (dest / c["file"]).write_text(json.dumps(config))
    for w in b["workloads"]:
        (dest / "mrbench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(TINY_TRAFFIC[w["traffic"]]))
    (dest / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.fixture
def tiny_root(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    write_tiny_root(root)
    return root

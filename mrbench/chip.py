"""The cards a run uses: the check that they are there, their name, their
memory peak and the profiler's activities. ``open_card`` is the one place
the harness reaches the card; the CPU tests put a stand-in there."""

from __future__ import annotations

import subprocess
import time


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class Card:
    platform = "gpu"
    device = "cuda"  # Config.device of the program's jobs

    def __init__(self, count: int) -> None:
        import torch

        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < count:
            raise NoCard(f"the cell needs {count} cards, "
                         f"torch sees {torch.cuda.device_count()}")
        self._torch = torch
        self.count = count
        self.kind = torch.cuda.get_device_name(0)
        self.generator_device = "cuda:0"

    def synchronize(self) -> None:
        for i in range(self.count):
            self._torch.cuda.synchronize(i)

    def reset_peak(self) -> None:
        for i in range(self.count):
            self._torch.cuda.reset_peak_memory_stats(i)

    def memory_peak(self) -> int:
        return max(int(self._torch.cuda.max_memory_allocated(i))
                   for i in range(self.count))

    def profiler_activities(self) -> list:
        """Device activity only: kernels, copies and memsets of every
        thread (the host's operators would make the trace of a window
        hundreds of MB)."""
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA]

    def mark(self) -> float:
        """Waits for the card, runs one marker kernel (``spin_kernel``, a
        kernel the program never launches), waits for it, and returns the
        host's perf_counter: the marker's end on the device trace's clock
        and this reading name one instant."""
        self.synchronize()
        self._torch.cuda._sleep(1000)
        self.synchronize()
        return time.perf_counter()

    def power_limit(self) -> str:
        """nvidia-smi's name and power limit of the first card."""
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", "-i", "0"],
                capture_output=True, text=True, timeout=30, check=False)
            return out.stdout.strip() or out.stderr.strip()
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"nvidia-smi: {e}"


def open_card(count: int) -> Card:
    return Card(count)

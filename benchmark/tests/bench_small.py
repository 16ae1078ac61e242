"""Helpers of the benchmark's tests: a cell of BENCHMARK.json at a small
grid, run by the harness on the CPU (the look for a card skipped)."""

import os
import time

from benchmark import harness

SMALL = 32
SEED = 2 ** 31 + 77


def small_cell(name: str, root: str = harness.ROOT, grid: int = SMALL):
    cell = harness.Cell(harness.load_spec(root), name, root=root)
    cell.config["params"].update(GridSize=grid, BoxSize=float(grid))
    return cell


def run_small(cell, tmp_path, trace: bool = False, seconds: float = 0.3,
              seed: int = SEED) -> dict:
    return harness.run(cell, seed, seconds, trace, "cpu",
                       time.perf_counter(), out_dir=os.path.join(
                           str(tmp_path), "out"))

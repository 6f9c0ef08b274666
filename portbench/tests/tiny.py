"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test can run: the same
files, drivers, references and limits, with narrow widths and short
crops."""

from __future__ import annotations

from portbench.harness import Cell, Clock, load_module

TINY_CONFIGS = {
    "vqvae": {"dim": 16, "codes": 32, "batch": 4},
    "wavenet": {"layers": 2, "stacks": 1, "residual_channels": 8, "gate_channels": 8,
                "skip_out_channels": 8, "crop_samples": 512, "frames": 2, "batch": 2},
}


def tiny_cell(name: str) -> Cell:
    cell = Cell(name)
    cell.config.update(TINY_CONFIGS[cell.config["family"]])
    return cell


def run_tiny(name: str, seed: int = 2**31 + 5, seconds: float = 1.0, fault=None, control=None,
             device="cpu"):
    cell = tiny_cell(name)
    driver = load_module("drivers", cell.traffic["driver"])
    return cell, driver.run(cell, seed, seconds, False, device, Clock(), fault=fault,
                            control=control)

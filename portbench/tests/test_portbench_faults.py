"""A run with the timed path broken underneath comes out not correct: the
harness's whole run past its look for a card, at small sizes on the CPU,
once for each fault a training cell can have: a step that leaves the state
unchanged, one that leaves the EMA shadow unchanged, half of each batch
left out (the mean over the rest), and steps that go wrong only after
set-up, inside the window. (One card holds each cell, so no exchange
between cards can be left out.)"""

import pytest

from portbench.run import judge
from portbench.tests.tiny import run_tiny

TRAINING = ["vqvae_mel.train_f32", "wavenet_mol.train_f32"]


@pytest.mark.parametrize("fault", ["frozen", "ema_frozen", "half_batch"])
@pytest.mark.parametrize("cell_name", TRAINING)
def test_a_broken_training_step_is_caught(cell_name, fault):
    cell, out = run_tiny(cell_name, fault=fault)
    correct, checks = judge(cell, out)
    assert not correct, checks


@pytest.mark.parametrize("cell_name", TRAINING)
def test_a_window_gone_wrong_is_caught(cell_name):
    """The check steps are sound, the window's are NaN: every window step
    counts as failed and ``correct`` is false."""
    cell, out = run_tiny(cell_name, fault="window_nan")
    correct, checks = judge(cell, out)
    assert not correct, checks
    assert out["attempted"] > 0 and out["failed"] == out["attempted"]
    assert all(c["value"] <= c["limit"] for name, c in checks.items() if name != "window_failed")


def test_a_frozen_ema_reads_one():
    """The EMA's change left at nought reads 1 on the median moved leaf."""
    _, out = run_tiny("vqvae_mel.train_f32", fault="ema_frozen", seconds=0.0)
    assert out["numbers"]["ema_median_gap"] == pytest.approx(1.0)


@pytest.mark.card
@pytest.mark.parametrize("cell_name", TRAINING)
def test_the_control_is_caught(card, cell_name):
    """The reference in TF32 put in the program's place, at the cell's own
    sizes on the card, fails the cell's limits."""
    from portbench.harness import Cell, Clock, load_module

    cell = Cell(cell_name)
    driver = load_module("drivers", cell.traffic["driver"])
    out = driver.run(cell, 2**31 + 21, 0.0, False, card, Clock(),
                     control=cell.traffic["control"])
    correct, checks = judge(cell, out)
    assert not correct, checks

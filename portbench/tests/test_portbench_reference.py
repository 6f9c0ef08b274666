"""The plain references against the port at small sizes on the CPU: the same
parameters by name and shape, and a whole run of each cell that the
comparison finds correct under the cell's own limits."""

import pytest
import torch

from portbench.harness import Cell, load_module
from portbench.run import judge
from portbench.tests.tiny import TINY_CONFIGS, run_tiny

FULL = {"vqvae_mel": "vqvae_mel.train_f32", "wavenet_mol": "wavenet_mol.train_f32"}


@pytest.mark.parametrize("cell_name", sorted(FULL.values()))
@pytest.mark.parametrize("size", ["published", "tiny"])
def test_parameter_tables_are_the_programs(cell_name, size):
    """Every parameter of the model the CLI builds has the reference's name
    and shape, at the published widths and the tests' small ones."""
    cell = Cell(cell_name)
    family = load_module("families", cell.config["family"])
    if size == "tiny":
        cell.config.update(TINY_CONFIGS[cell.config["family"]])
    table = family.param_table(cell.config)
    weights = {name: torch.zeros(shape) for name, shape, _, _ in table}
    trainer, state = family.build_program(cell.config, cell.traffic, weights, "cpu")
    program = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    assert program == {name: tuple(shape) for name, shape, _, _ in table}


@pytest.mark.parametrize("cell_name", ["vqvae_mel.train_f32", "wavenet_mol.train_f32"])
def test_a_sound_training_run_is_correct(cell_name):
    cell, out = run_tiny(cell_name)
    correct, checks = judge(cell, out)
    assert correct, checks
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["e2e"]["train_audio_rate"] > 0


def test_the_reference_ema_follows_its_decay():
    """After one step from ema = p0 the shadow is d p0 + (1 - d) p1, d in
    float32."""
    import torch

    from portbench.reference.common import Adam

    p = {"w": torch.tensor([1.0, -2.0], requires_grad=True)}
    opt = Adam(p, lr=0.5, ema_decay=0.75)
    p0 = p["w"].detach().clone()
    opt.step(p, {"w": torch.tensor([1.0, -1.0])})
    assert torch.allclose(opt.ema["w"], 0.75 * p0 + 0.25 * p["w"].detach())


def test_weights_follow_the_seed():
    from portbench.reference.common import make_weights

    table = load_module("families", "vqvae").param_table(TINY_CONFIGS["vqvae"] | {"input_dim": 1})
    a = make_weights(table, torch.Generator().manual_seed(2**31 + 3), "cpu")
    b = make_weights(table, torch.Generator().manual_seed(2**31 + 3), "cpu")
    c = make_weights(table, torch.Generator().manual_seed(7), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["codebook"], c["codebook"])
    assert float(a["codebook"].abs().max()) <= 1.0 / 32

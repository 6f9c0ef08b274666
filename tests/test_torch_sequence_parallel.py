"""Sequence parallelism (``parallel.sequence``): the halo-exchange 1-D
convolution on the CPU.

Two gloo launches of ``tests/torch_seq_worker.py`` (worlds of 2 and 4,
joined through ``file://`` rendezvous) run ``sharded_conv1d`` and
``halo_conv1d`` on the same seeded input along the mesh's data axis, and
at a world of 4 also along the model axis of a (2 x 2) mesh. Each rank's
output and gradients are held against JAX's ``sharded_conv1d`` on a 2- and
4-device CPU mesh (the conftest's virtual devices) under ``jax.grad``, and
against the port's whole-array convolution. Cases: causal K 5; causal K 3
at dilation 4; "same" K 5; "same" K 4 (uneven halves).

Tolerances: outputs and gradients 1e-5 absolute (float32 at unit scale;
the shards reorder no sum of the convolution, the kernel's gradient sums
its shards' parts once more). The refusals name their sizes; no gloo
thread outlives ``distributed.shutdown()``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import torch_seq_worker as worker
from neural_sound_generation_tpu.parallel.sequence import sharded_conv1d as jax_sharded_conv1d
from neural_sound_generation_tpu_torch.parallel import sequence

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
ATOL = 1e-5


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _inputs():
    rng = np.random.default_rng(0)
    arr = {"x": rng.standard_normal((worker.B, worker.T, worker.CIN)),
           "w": rng.standard_normal((worker.B, worker.T, worker.COUT))}
    for k in {k for k, _, _ in worker.CASES.values()}:
        arr[f"kernel_k{k}"] = rng.standard_normal((k, worker.CIN, worker.COUT)) / k
    return {name: np.asarray(a, np.float32) for name, a in arr.items()}


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    arrays = _inputs()
    inp = {k: torch.from_numpy(v) for k, v in arrays.items()}
    procs, dirs = {}, {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"seq_w{world}")
        torch.save(inp, d / "inputs.pt")
        dirs[world] = d
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_seq_worker.py"), str(r),
             str(world), str(d)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=_env()) for r in range(world)]
    threads = {}
    for world, ps in procs.items():
        try:
            outs = [p.communicate(timeout=240)[0] for p in ps]
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(ps, outs)):
            assert p.returncode == 0, f"world {world} rank {r} failed:\n{out}"
        threads[world] = [json.loads([line for line in out.splitlines()
                                      if line.startswith('{"threads"')][-1])["threads"]
                          for out in outs]
    ranks = {world: [torch.load(dirs[world] / f"rank{r}.pt", weights_only=True)
                     for r in range(world)] for world in WORLDS}
    return {"ranks": ranks, "threads": threads, "arrays": arrays}


def _jax_reference(arrays, name: str, n: int):
    """JAX's sharded_conv1d on an n-device mesh: (y, dx, dkernel) of sum(y * w)."""
    k, dilation, causal = worker.CASES[name]
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("data",))

    def loss(x, kernel):
        y = jax_sharded_conv1d(x, kernel, mesh, causal=causal, dilation=dilation)
        return jnp.sum(y * arrays["w"]), y

    (_, y), (dx, dk) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(arrays["x"]), jnp.asarray(arrays[f"kernel_k{k}"]))
    return np.asarray(y), np.asarray(dx), np.asarray(dk)


def _whole(arrays, name: str):
    """The port's one-rank convolution of the whole array, with gradients."""
    k, dilation, causal = worker.CASES[name]
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    kernel = torch.from_numpy(arrays[f"kernel_k{k}"]).requires_grad_(True)
    y = sequence.sharded_conv1d(x, kernel, None, causal=causal, dilation=dilation)
    (y * torch.from_numpy(arrays["w"])).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), kernel.grad.numpy()


def _launches():
    out = [(world, f"data.{name}", world) for world in WORLDS for name in worker.CASES]
    out += [(4, f"model.{name}", 2) for name in worker.CASES]
    return out


@pytest.mark.parametrize("world,case,n", _launches())
def test_sharded_conv1d_equals_jax_and_the_whole_array(seq, world, case, n):
    """Every rank returns the whole output; x's gradient is the whole
    one on every rank and the kernel's is summed over the axis."""
    name = case.split(".", 1)[1]
    y_j, dx_j, dk_j = _jax_reference(seq["arrays"], name, n)
    y_w, dx_w, dk_w = _whole(seq["arrays"], name)
    np.testing.assert_allclose(y_w, y_j, rtol=0, atol=ATOL)
    for rec in (r[case] for r in seq["ranks"][world]):
        assert rec["n"] == n
        for got, jax_ref, whole in ((rec["y"], y_j, y_w), (rec["x_grad"], dx_j, dx_w),
                                    (rec["kernel_grad"], dk_j, dk_w)):
            np.testing.assert_allclose(got.numpy(), jax_ref, rtol=0, atol=ATOL)
            np.testing.assert_allclose(got.numpy(), whole, rtol=0, atol=ATOL)


@pytest.mark.parametrize("world,case,n", _launches())
def test_halo_conv1d_shards_equal_the_whole_array(seq, world, case, n):
    """Each rank's halo_conv1d output and input gradient are its slice of
    the whole convolution's; the kernel's gradients sum to the whole one
    over a line of the axis."""
    name = case.split(".", 1)[1]
    y_w, dx_w, dk_w = _whole(seq["arrays"], name)
    t = worker.T // n
    lines: dict = {}
    for r, rec in enumerate(seq["ranks"][world]):
        rec = rec[case]
        i = rec["index"]
        np.testing.assert_allclose(rec["y_local"].numpy(), y_w[:, i * t:(i + 1) * t],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(rec["x_local_grad"].numpy(), dx_w[:, i * t:(i + 1) * t],
                                   rtol=0, atol=ATOL)
        # the ranks of one line of the axis: the other coordinate
        line = r // n if case.startswith("model.") else r % (world // n)
        lines.setdefault(line, []).append(rec["kernel_local_grad"].numpy())
    for parts in lines.values():
        assert len(parts) == n
        np.testing.assert_allclose(np.sum(parts, axis=0), dk_w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_name_the_sizes(seq, world):
    """T that does not divide over the axis (JAX asserts) and a halo
    longer than a shard (JAX's concatenation would come out short) raise
    ValueError naming their sizes."""
    for rec in seq["ranks"][world]:
        ref = rec["refusals"]
        assert f"time axis {worker.T - 1} must divide over {world}" in ref["indivisible"]
        assert f"{4 * worker.T} samples exceeds a shard's {worker.T // world}" in ref["long_halo"]


@pytest.mark.parametrize("world", WORLDS)
def test_no_gloo_thread_outlives_the_process_group(seq, world):
    """The pair groups of the halo exchange are destroyed with the rest by
    ``distributed.shutdown()``."""
    for r, names in enumerate(seq["threads"][world]):
        assert not [n for n in names if "gloo" in n], f"rank {r}: {names}"


@pytest.mark.parametrize("causal", [True, False])
def test_without_a_group_both_are_the_plain_convolution(causal):
    """W 1: sharded_conv1d and halo_conv1d are the causal or "same"
    conv1d of the whole array."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, 3)).astype(np.float32))
    kernel = torch.from_numpy(rng.standard_normal((4, 3, 5)).astype(np.float32))
    w = kernel.permute(2, 1, 0)
    xt = x.transpose(1, 2)
    pad = (6, 0) if causal else (3, 3)
    want = torch.nn.functional.conv1d(torch.nn.functional.pad(xt, pad), w, dilation=2)
    want = want.transpose(1, 2)
    for fn in (sequence.sharded_conv1d, sequence.halo_conv1d):
        got = fn(x, kernel, causal=causal, dilation=2) if fn is sequence.halo_conv1d else fn(
            x, kernel, None, causal=causal, dilation=2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

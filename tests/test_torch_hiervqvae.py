"""The port's HierVQVAE held against the JAX package on the CPU, with the JAX
weights carried over by the bridge (convert.py): eval and train forwards,
``encode``/``decode``, the BatchNorm running averages after a train forward,
``hier_vqvae_loss``, one train step and one eval step, the checked-in
goldens, ``--bf16`` and ``--norm group``, the two-pass data codebook init,
the bridge's round trip, and ``cli.main``, ``cli.evaluate`` and ``cli.serve
--model hiervqvae`` end to end on a synthetic corpus.

Tolerances: ATOL 1e-4 for forwards (float32 convolutions summed in another
order), codes equal; bf16 within 2e-2 of the largest |x_tilde| with >= 99%
of the codes equal (``tests/test_torch_models.py``'s bf16 rule); one train
step as ``tests/test_torch_training.py``.
"""

import contextlib
import importlib
import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from neural_sound_generation_tpu.cli import main as jmain
from neural_sound_generation_tpu.cli import serve as jserve
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import HierVQVAE as JaxHier
from neural_sound_generation_tpu.training import losses as jlosses
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import evaluate, main, serve
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, write_manifest
from neural_sound_generation_tpu_torch.models import HierVQVAE
from neural_sound_generation_tpu_torch.models import layers
from neural_sound_generation_tpu_torch.training import checkpoint, losses, trainer
from torch_parity import (
    ATOL,
    TrainPair,
    assert_metrics,
    assert_round_trip,
    cfgs,
    np_tree,
    perturb_params,
    perturb_stats,
)

torch.set_num_threads(1)

DIM, Z, ZT, SR = 16, 32, 24, 22050
LOSS_KEYS = ("loss", "loss_recons", "loss_vq", "loss_commit", "train_loss", "loss_vq_top",
             "loss_vq_bottom", "loss_commit_top", "loss_commit_bottom")


def _levels(jm, v, x, train):
    out = jm.apply(v, jnp.asarray(x), train, method=lambda m, xx, t: m._levels(xx, t),
                   mutable=["batch_stats"] if train else False)
    return out[0] if train else out


def _seed_rows(ze, k, rng):
    flat = np.asarray(ze).reshape(-1, ze.shape[-1])
    pick = rng.choice(flat.shape[0], k, replace=flat.shape[0] < k)
    return (flat[pick] + 0.01 * rng.standard_normal((k, flat.shape[1]))).astype(np.float32)


def _pair(norm="batch", bf16=False, seed=0, train_codebooks=False):
    """A JAX HierVQVAE with perturbed weights and statistics whose codebooks
    are seeded from its own z_e (top first, then the bottom under the
    seeded top), so that codes vary, and the port's copy in eval mode."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 80, 16, 1)).astype(np.float32)
    jm = JaxHier(input_dim=1, dim=DIM, z_dim=Z, z_dim_top=ZT, norm=norm,
                 dtype=jnp.bfloat16 if bf16 else jnp.float32)
    v = np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]), train=False))
    v = perturb_params(perturb_stats(v, seed + 1), seed + 2, scale=0.05)
    top, _ = _levels(jm, v, x, train_codebooks)
    v["params"]["codebook_top"] = _seed_rows(top[1], ZT, rng)
    _, bottom = _levels(jm, v, x, train_codebooks)
    v["params"]["codebook_bottom"] = _seed_rows(bottom[1], Z, rng)
    tm = HierVQVAE(1, DIM, Z, ZT, norm=norm, dtype=torch.bfloat16 if bf16 else torch.float32)
    tm.load_state_dict(convert.flax_to_state_dict(v, tm))
    tm.eval()
    return jm, v, tm, x


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_eval_forward_encode_decode_match_jax(norm):
    jm, v, tm, x = _pair(norm)
    xt, (zet, zqt), (zeb, zqb) = jm.apply(v, jnp.asarray(x), train=False)
    idx_t, idx_b = (np.asarray(a) for a in jm.apply(v, jnp.asarray(x), train=False,
                                                    method=JaxHier.encode))
    dec = jm.apply(v, jnp.asarray(idx_t), jnp.asarray(idx_b), train=False, method=JaxHier.decode)
    with torch.no_grad():
        txt, (tzet, tzqt), (tzeb, tzqb) = tm(torch.from_numpy(x))
        tidx_t, tidx_b = tm.encode(torch.from_numpy(x))
        tdec = tm.decode(torch.from_numpy(idx_t), torch.from_numpy(idx_b))
    assert idx_t.shape == (4, 10, 2) and idx_b.shape == (4, 20, 4)
    assert tidx_t.dtype == torch.int32 and tidx_b.dtype == torch.int32
    assert len(np.unique(idx_t)) > 6 and len(np.unique(idx_b)) > 8  # both levels in use
    np.testing.assert_array_equal(tidx_t.numpy(), idx_t)
    np.testing.assert_array_equal(tidx_b.numpy(), idx_b)
    for got, want in ((tzet, zet), (tzqt, zqt), (tzeb, zeb), (tzqb, zqb), (txt, xt),
                      (tdec, dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_matches_golden():
    """tests/golden/models_golden.npz holds the JAX HierVQVAE's outputs at dim
    8, 16 bottom and 12 top codes, init PRNGKey(8) (hier_xt, hier_zet,
    hier_zeb): the same init through the bridge reproduces them."""
    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "models_golden.npz"))
    jm = JaxHier(input_dim=1, dim=8, z_dim=16, z_dim_top=12)
    v = np_tree(jm.init(jax.random.PRNGKey(8), jnp.asarray(g["vqvae_in"]), train=False))
    tm = HierVQVAE(1, 8, 16, 12)
    tm.load_state_dict(convert.flax_to_state_dict(v, tm))
    tm.eval()
    with torch.no_grad():
        xt, (zet, _), (zeb, _) = tm(torch.from_numpy(g["vqvae_in"]))
    np.testing.assert_allclose(xt.numpy(), g["hier_xt"], atol=ATOL)
    np.testing.assert_allclose(zet.numpy(), g["hier_zet"], atol=ATOL)
    np.testing.assert_allclose(zeb.numpy(), g["hier_zeb"], atol=ATOL)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_train_forward_running_averages_and_loss_match_jax(norm):
    """Train mode: batch statistics, both levels' codes, the running
    averages after the pass (batch norm) and hier_vqvae_loss's terms."""
    jm, v, tm, x = _pair(norm, seed=3, train_codebooks=True)
    (xt, top, bottom), mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    _, jmetrics = jlosses.hier_vqvae_loss(xt, jnp.asarray(x), (top, bottom), 0.25)
    tm.train()
    with torch.no_grad():
        txt, ttop, tbottom = tm(torch.from_numpy(x))
        _, tmetrics = losses.hier_vqvae_loss(txt, torch.from_numpy(x), (ttop, tbottom), 0.25)
    np.testing.assert_allclose(txt.numpy(), np.asarray(xt), atol=ATOL)
    for got, want in zip((*ttop, *tbottom), (*top, *bottom)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert set(tmetrics) == set(jmetrics) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    if norm == "batch":
        stats = convert.module_to_flax(tm)["batch_stats"]
        np.testing.assert_allclose(ravel_pytree(stats)[0],
                                   ravel_pytree(np_tree(mut["batch_stats"]))[0], atol=1e-5)


def test_bf16_eval_forward_matches_jax_bf16():
    """--bf16: convs in bf16, z_e to float32 before each VQ; the rounding
    flips of float32 sums in another order travel (the flat model's rule)."""
    jm, v, tm, x = _pair(bf16=True, seed=4)
    xt, _, _ = jm.apply(v, jnp.asarray(x), train=False)
    idx_t, idx_b = jm.apply(v, jnp.asarray(x), train=False, method=JaxHier.encode)
    with torch.no_grad():
        txt, (tzet, _), (tzeb, _) = tm(torch.from_numpy(x))
        tidx_t, tidx_b = tm.encode(torch.from_numpy(x))
    assert txt.dtype == tzet.dtype == tzeb.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    scale = float(np.abs(np.asarray(xt)).max())
    assert float(np.abs(txt.numpy() - np.asarray(xt)).max()) <= 2e-2 * scale
    assert float((tidx_t.numpy() == np.asarray(idx_t)).mean()) >= 0.99
    assert float((tidx_b.numpy() == np.asarray(idx_b)).mean()) >= 0.99


def test_one_train_step_and_eval_step_match_jax():
    """Both codebooks learn by gradient (EMA codebooks stay off for the
    hierarchy even when asked for). Gradients, every loss term, grad_norm and
    the whole state after the step; then the eval step's metrics, the
    perplexities of both levels among them."""
    jm, v, tm, x = _pair(seed=5, train_codebooks=True)
    jcfg, tcfg = cfgs(beta=0.25, dim=DIM, z_dim=Z, model="hiervqvae", ema_codebook=True)
    pair = TrainPair(jm, v, tm, jcfg, tcfg, seed=5)
    assert pair.tstate.codebook_ema is None and not trainer.uses_ema_codebook(tm, tcfg)
    batch = {"x": jnp.asarray(x)}
    _, jgrads = jax.value_and_grad(jtrainer._hier_vqvae_loss_fn(jm, 0.25), has_aux=True)(
        pair.jstate.params, pair.jstate.batch_stats, batch, None)
    jstate, jmetrics = jtrainer.make_train_step(jm, jcfg, donate=False)(
        pair.jstate, batch, jax.random.PRNGKey(0))
    _, tmetrics = trainer.make_train_step(tm, tcfg)(pair.tstate, {"x": torch.from_numpy(x)})
    pair.assert_grads_match(jgrads)
    assert float(pair.tstate.flat.view("codebook_top", pair.tstate.flat.grad).abs().max()) > 0
    assert_metrics(tmetrics, jmetrics, LOSS_KEYS)
    pair.assert_states_match(jstate)

    jx, jeval = jtrainer.make_eval_step(jm, jcfg)(jstate, batch)
    tx, teval = trainer.make_eval_step(tm, tcfg)(pair.tstate, {"x": torch.from_numpy(x)})
    assert set(teval) == set(jeval) == {*LOSS_KEYS, "perplexity", "perplexity_top"}
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)
    for k in jeval:
        np.testing.assert_allclose(float(teval[k]), float(jeval[k]), rtol=1e-4, err_msg=k)


def test_two_pass_data_codebook_init_matches_jax(monkeypatch):
    """--codebook-init data on the hierarchy: the top codebook is drawn from
    the first train-mode pass's z_e_top, the bottom one from a second pass's
    z_e_bottom under the seeded top; the BatchNorm statistics are left as
    they were. Both sides' draws are replaced by one rule (evenly spaced
    rows), so the passes can be compared with the JAX CLI's."""
    jm, v, tm, x = _pair(seed=6)
    seen = {"jax": [], "port": []}

    def rows(n, k):
        return np.linspace(0, n - 1, k).astype(np.int64)

    def jax_init(z_e, shape, key, noise_scale=0.01):
        flat = np.asarray(z_e).reshape(-1, shape[-1])
        seen["jax"].append(flat)
        return jnp.asarray(flat[rows(flat.shape[0], shape[0])])

    def port_init(z_e, shape, generator, noise_scale=0.01, draws=None):
        flat = z_e.reshape(-1, shape[-1])
        seen["port"].append(flat.numpy().copy())
        return flat[torch.from_numpy(rows(flat.shape[0], shape[0]))]

    monkeypatch.setattr(importlib.import_module("neural_sound_generation_tpu.ops.vq"),
                        "data_codebook_init", jax_init)
    monkeypatch.setattr(main, "data_codebook_init", port_init)
    jv = jmain._apply_data_codebook_init(jm, v, jnp.asarray(x), jax.random.PRNGKey(0))

    tm.train()
    with torch.no_grad(), layers.batch_stats_discarded(tm):
        z_e_top = tm.levels(torch.from_numpy(x))[0][1].reshape(-1, DIM).numpy()
    stats = {k: b.clone() for k, b in tm.named_buffers()}
    main.apply_data_codebook_init(tm, torch.from_numpy(x), torch.Generator())
    for k, b in tm.named_buffers():
        assert torch.equal(b, stats[k]), k
    with torch.no_grad(), layers.batch_stats_discarded(tm):
        z_e_bottom = tm.levels(torch.from_numpy(x))[1][1].reshape(-1, DIM).numpy()

    assert [a.shape for a in seen["port"]] == [a.shape for a in seen["jax"]] == [
        (4 * 10 * 2, DIM), (4 * 20 * 4, DIM)]
    np.testing.assert_array_equal(seen["port"][0], z_e_top)      # the first pass
    np.testing.assert_array_equal(seen["port"][1], z_e_bottom)   # under the seeded top
    for got, want in zip(seen["port"], seen["jax"]):
        np.testing.assert_allclose(got, want, atol=ATOL)
    for name in ("codebook_top", "codebook_bottom"):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   np.asarray(jv["params"][name]), atol=ATOL)


def test_bridge_round_trip_is_bit_exact():
    _, v, tm, _ = _pair()
    assert_round_trip(v, tm)


def test_init_is_seeded_with_both_codebooks_in_their_balls():
    a = HierVQVAE(1, 16, 32, 24, generator=torch.Generator().manual_seed(0))
    b = HierVQVAE(1, 16, 32, 24, generator=torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert tuple(a.codebook_top.shape) == (24, 16) and a.k_top == 24
    assert float(a.codebook_top.detach().abs().max()) <= 1 / 24
    assert float(a.codebook_bottom.detach().abs().max()) <= 1 / 32
    assert HierVQVAE(1, 16, 32).k_top == 32


# -- cli.main, cli.evaluate and cli.serve on a synthetic corpus --------------


def _corpus(root, n=40):
    """Chirps of 0.3-0.5 s with mels from the port's own analysis."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.ops import dsp

    rng = np.random.default_rng(0)
    entries = []
    for i in range(n):
        t = np.arange(int(SR * rng.uniform(0.3, 0.5))) / SR
        f = rng.uniform(100, 300) + rng.uniform(500, 2500) * t / t[-1]
        wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / SR)).astype(np.float32)
        mel = dsp.melspectrogram(torch.from_numpy(wav), Config().audio).T.numpy()
        np.save(os.path.join(root, f"a{i}.npy"), wav)
        np.save(os.path.join(root, f"m{i}.npy"), mel.astype(np.float32))
        entries.append(ManifestEntry(f"a{i}.npy", f"m{i}.npy", len(wav), "chirp"))
    write_manifest(root, entries)
    return root


def _train_args(root, datadir, *extra):
    return ["--model", "hiervqvae", "--dataset", "ljspeech", "--datadir", datadir,
            "--dim", str(DIM), "--z-dim", str(Z), "--batch-size", "4",
            "--max-batches-per-epoch", "3", "--log-interval", "1", "--device", "cpu",
            "--ckpt-dir", os.path.join(root, "models"),
            "--sampledir", os.path.join(root, "results"), *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hier"))
    os.makedirs(os.path.join(root, "corpus"))
    datadir = _corpus(os.path.join(root, "corpus"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main.main(_train_args(root, datadir, "--epochs", "2", "--codebook-init", "data"))
    ckpt = os.path.join(root, "models", "hiervqvae", f"checkpoint_ljspeech_{DIM}_{Z}")
    return root, datadir, ckpt, out.getvalue()


def test_cli_main_trains_and_resumes_hiervqvae(trained):
    root, datadir, ckpt, log = trained
    assert "codebook_top seeded" in log and "codebook_bottom seeded" in log
    assert checkpoint.latest_step(ckpt) == 6
    assert checkpoint.read_extra(ckpt) == {"epoch": 2, "arch": "hiervqvae",
                                           "num_quantizers": 1, "num_downsample": 6}
    logged = [float(t.split("=")[1]) for t in log.split() if t.startswith("loss=")]
    assert len(logged) == 6 and all(np.isfinite(logged))
    assert "loss_vq_top=" in log and "loss_commit_bottom=" in log
    recon = np.load(os.path.join(root, "results", "ljspeech",
                                 f"reconstruction_hiervqvae_data_ljspeech_dim_{DIM}_z_dim_{Z}"
                                 f"_epoch_2.npy"))
    assert recon.shape[1:] == (80, 24)  # 8-aligned crops: 31 frames -> 24
    main.main(_train_args(root, datadir, "--epochs", "3", "--resume"))
    assert checkpoint.latest_step(ckpt) == 9
    assert checkpoint.read_extra(ckpt)["epoch"] == 3


def test_cli_evaluate_hiervqvae(trained):
    _, datadir, ckpt, _ = trained
    means = evaluate.main(["--model", "hiervqvae", "--datadir", datadir, "--ckpt-dir", ckpt,
                           "--dim", str(DIM), "--z-dim", str(Z), "--batch-size", "4",
                           "--device", "cpu"])
    assert {"loss", "perplexity", "perplexity_top", "loss_vq_top"} <= set(means)
    assert np.isfinite(means["loss"]) and means["perplexity_top"] >= 1.0
    with pytest.raises(SystemExit, match="trained with arch='hiervqvae'"):
        evaluate.main(["--model", "vqvae", "--datadir", datadir, "--ckpt-dir", ckpt,
                       "--dim", str(DIM), "--z-dim", str(Z), "--device", "cpu"])


def _wav_bytes(seconds, f0=330.0):
    from scipy.io import wavfile

    t = np.arange(int(SR * seconds)) / SR
    f = f0 + 1500.0 * t / seconds
    wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / SR) * 32767).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, SR, wav)
    return buf.getvalue()


def _serve_args(ckpt, *extra):
    return serve.parse_args(["--device", "cpu", "--model", "hiervqvae", "--ckpt-dir", ckpt,
                             "--dim", str(DIM), "--z-dim", str(Z), *extra])


@pytest.fixture(scope="module")
def served(trained):
    _, _, ckpt, _ = trained
    svc = serve.build_service(_serve_args(ckpt, "--frames", "16"))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield svc, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def _post(url, data):
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=120) as r:
        return r.status, r.read()


def test_serve_defaults_to_80_frame_windows(trained):
    _, _, ckpt, _ = trained
    assert serve.parse_args(["--model", "hiervqvae"]).frames == 80
    assert serve.parse_args([]).frames == 84
    svc = serve.build_service(_serve_args(ckpt))
    assert svc.hier and svc.frames == 80


@pytest.mark.parametrize("seconds", [0.5, 2.0])
def test_serve_endpoints_match_the_jax_service(served, seconds):
    """/encode answers the JAX package's keys with both grids aligned (the
    bottom exactly twice the top's width) and the JAX service's codes for
    the same weights; /decode takes them back; /reconstruct keeps the
    input's length."""
    svc, url = served
    wav = _wav_bytes(seconds)
    status, body = _post(url + "/encode", wav)
    got = json.loads(body)
    assert status == 200
    assert set(got) == {"codes_top", "shape_top", "codes_bottom", "shape_bottom"}
    top, bottom = np.asarray(got["codes_top"]), np.asarray(got["codes_bottom"])
    assert list(top.shape) == got["shape_top"] and list(bottom.shape) == got["shape_bottom"]
    assert top.shape[0] == 10 and bottom.shape == (20, 2 * top.shape[1])

    variables = convert.module_to_flax(svc.model)
    jsvc = jserve.InferenceService(JaxConfig(), JaxHier(input_dim=1, dim=DIM, z_dim=Z),
                                   variables, frames=16)
    want = jsvc.encode(wav)
    assert set(want) == set(got)
    np.testing.assert_array_equal(top, np.asarray(want["codes_top"]))
    np.testing.assert_array_equal(bottom, np.asarray(want["codes_bottom"]))

    status, body = _post(url + "/decode", json.dumps(
        {"codes_top": got["codes_top"], "codes_bottom": got["codes_bottom"]}).encode())
    assert status == 200 and body[:4] == b"RIFF"
    status, body = _post(url + "/reconstruct", wav)
    from scipy.io import wavfile

    sr, out = wavfile.read(io.BytesIO(body))
    assert status == 200 and sr == SR and len(out) == int(SR * seconds)
    assert np.isfinite(out.astype(np.float64)).all()


@pytest.mark.parametrize("payload", [
    {"codes_top": [[1, 2]] * 10, "codes_bottom": [[1, 2, 3]] * 20},      # misaligned
    {"codes_top": [[1, 2]] * 10, "codes_bottom": [[1, 2, 3, 99999]] * 20},  # out of range
    {"codes_top": [[1, 2]] * 9, "codes_bottom": [[1, 2, 3, 4]] * 20},     # wrong height
    {"codes_top": [[-1, 2]] * 10, "codes_bottom": [[1, 2, 3, 4]] * 20},
    {"codes": [[1] * 4] * 20},
])
def test_serve_decode_refuses_bad_grids(served, payload):
    _, url = served
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url + "/decode", json.dumps(payload).encode())
    assert err.value.code == 400


def test_serve_refusals(trained, tmp_path):
    _, _, ckpt, _ = trained
    with pytest.raises(SystemExit, match="multiple of 8"):
        serve.build_service(_serve_args(ckpt, "--frames", "84"))
    # /sample needs both priors (served in tests/test_torch_hier_prior.py)
    with pytest.raises(SystemExit, match="needs --bottom-ckpt"):
        serve.build_service(_serve_args(ckpt, "--prior-ckpt", str(tmp_path)))
    with pytest.raises(SystemExit, match="beside its top prior"):
        serve.build_service(_serve_args(ckpt, "--bottom-ckpt", str(tmp_path)))
    preset = tmp_path / "multi.json"
    preset.write_text(json.dumps({"gin_channels": 16, "n_speakers": 4}))
    with pytest.raises(SystemExit, match="speaker-conditioned"):
        serve.build_service(_serve_args(ckpt, "--preset", str(preset)))
    with pytest.raises(SystemExit, match="arch='hiervqvae'"):  # a flat template
        serve.build_service(serve.parse_args(["--device", "cpu", "--ckpt-dir", ckpt,
                                              "--dim", str(DIM), "--z-dim", str(Z)]))
    with pytest.raises(ValueError, match="multiple of 8"):
        serve.InferenceService(serve.Config(), HierVQVAE(1, DIM, Z), frames=12, device="cpu")

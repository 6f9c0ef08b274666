"""The hierarchical prior chain of the port held against the JAX package on
the CPU: the spatially conditioned TransformerPrior (``cond_proj`` on the
teacher-forced path and the KV-cached decode, one train step),
``hier_cond_map`` and ``sample_hier_mels`` with the JAX draws injected, on
the HierVQVAE pair of ``tests/test_torch_hiervqvae.py`` (dim 16, 32 bottom
and 24 top codes); then ``cli.prior train --hier --hier-level top|bottom``,
``cli.prior sample --hier --bottom-*`` and ``cli.serve --model hiervqvae``
``/sample`` end to end on a synthetic corpus, and the checkpoint metadata
that refuses a bottom prior where a top one is expected.

Tolerances as in ``tests/test_torch_transformer_prior.py`` and
``tests/test_torch_pixelcnn.py``: logits 1e-5 absolute; sampled codes equal
except at near-ties of the JAX draw (1e-5 for the PixelCNN's Gumbel-max,
1e-4 for the transformer's, whose KV cache sums in another order); decoded
mels 1e-4 (``tests/torch_parity.py``'s ATOL for forwards); one train step
as ``tests/torch_parity.py``.
"""

import contextlib
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

from neural_sound_generation_tpu import inference as jinference
from neural_sound_generation_tpu.models import pixelcnn as jpc
from neural_sound_generation_tpu.models import transformer_prior as jtp
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert, inference
from neural_sound_generation_tpu_torch.cli import main, prior, serve
from neural_sound_generation_tpu_torch.models import GatedPixelCNN, TransformerPrior
from neural_sound_generation_tpu_torch.models import transformer_prior as tp
from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
from neural_sound_generation_tpu_torch.training import checkpoint, trainer
from test_torch_hiervqvae import DIM, SR, Z, ZT, _corpus
from test_torch_hiervqvae import _pair as hier_pair
from test_torch_pixelcnn import assert_same_draws, jax_gumbel
from torch_parity import ATOL, TrainPair, assert_metrics, cfgs, np_tree, perturb_params

torch.set_num_threads(1)

T_DIM, T_HEADS, T_LAYERS, CLASSES = 32, 2, 2, 4
P_DIM, P_LAYERS = 16, 3
B, H, W = 2, 4, 5
LOGIT_ATOL = 1e-5


def _inputs(seed, k, b=B, h=H, w=W, cond_dim=DIM):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, k, (b, h, w)).astype(np.int32),
            rng.integers(0, CLASSES, b).astype(np.int32),
            rng.standard_normal((b, h, w, cond_dim)).astype(np.float32))


def _port(jm, variables):
    """The port's module for the JAX prior ``jm``, with its weights."""
    if isinstance(jm, jtp.TransformerPrior):
        tm = TransformerPrior(jm.input_dim, jm.dim, jm.n_layers, jm.n_heads, jm.n_classes,
                              spatial_cond=jm.spatial_cond,
                              cond_dim=DIM if jm.spatial_cond else 0)
    else:
        tm = GatedPixelCNN(jm.input_dim, jm.dim, jm.n_layers, jm.n_classes,
                           spatial_cond=jm.spatial_cond, cond_dim=DIM if jm.spatial_cond else 0)
    tm.load_state_dict(convert.flax_to_state_dict(variables, tm))
    return tm.eval()


def _prior_pair(arch, k, spatial, seed):
    """(JAX module, numpy variables, port module) with perturbed weights."""
    if arch == "transformer":
        jm = jtp.TransformerPrior(input_dim=k, dim=T_DIM, n_layers=T_LAYERS, n_heads=T_HEADS,
                                  n_classes=CLASSES, spatial_cond=spatial)
    else:
        jm = jpc.GatedPixelCNN(input_dim=k, dim=P_DIM, n_layers=P_LAYERS, n_classes=CLASSES,
                               spatial_cond=spatial)
    codes, labels, cond = _inputs(seed, k)
    args = (jnp.asarray(codes), jnp.asarray(labels)) + ((jnp.asarray(cond),) if spatial else ())
    v = perturb_params(np_tree(jm.init(jax.random.PRNGKey(seed), *args)), seed + 1, scale=0.05)
    return jm, v, _port(jm, v)


def _jvars(v):
    return jax.tree_util.tree_map(jnp.asarray, v)


def test_spatial_transformer_logits_and_cached_decode_match_jax():
    jm, v, tm = _prior_pair("transformer", Z, True, seed=0)
    codes, labels, cond = _inputs(1, Z)
    jargs = (jnp.asarray(codes), jnp.asarray(labels), jnp.asarray(cond))
    targs = (torch.from_numpy(codes), torch.from_numpy(labels), torch.from_numpy(cond))
    with torch.no_grad():
        got = tm(*targs).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(_jvars(v), *jargs)), atol=LOGIT_ATOL)
    inc = tp.incremental_logits(tm, *targs).numpy()
    np.testing.assert_allclose(inc, got, atol=LOGIT_ATOL)
    jinc = np.asarray(jtp.incremental_logits(jm, _jvars(v), *jargs))
    np.testing.assert_allclose(inc, jinc, atol=LOGIT_ATOL)
    with pytest.raises(ValueError, match="cond_map"):
        tm(*targs[:2])
    # the conditioning moves the logits
    with torch.no_grad():
        assert not np.allclose(tm(targs[0], targs[1], torch.zeros_like(targs[2])).numpy(), got)


def test_spatial_transformer_generate_with_jax_gumbel_draws_the_jax_codes():
    jm, v, tm = _prior_pair("transformer", Z, True, seed=2)
    _, labels, cond = _inputs(3, Z)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jtp.generate(jm, _jvars(v), jnp.asarray(labels), key, shape=(H, W),
                                   batch_size=B, cond_map=jnp.asarray(cond)))
    gumbel = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(key, t), (B, Z)))
                       for t in range(H * W)])
    got = tp.generate(tm, torch.from_numpy(labels), shape=(H, W), batch_size=B,
                      gumbel=torch.from_numpy(gumbel), cond_map=torch.from_numpy(cond)).numpy()
    logits = np.asarray(jm.apply(_jvars(v), jnp.asarray(want), jnp.asarray(labels),
                                 jnp.asarray(cond)))
    for bi in range(B):
        diff = np.argwhere(got[bi] != want[bi])
        if len(diff):
            i, j = diff[0]
            top2 = np.sort(logits[bi, i, j] + gumbel[i * W + j, bi])[-2:]
            assert top2[1] - top2[0] <= 1e-4, (bi, i, j, top2)


def test_spatial_transformer_train_step_matches_the_jax_trainer():
    jm, v, tm = _prior_pair("transformer", Z, True, seed=5)
    tm.train()
    jcfg, tcfg = cfgs()
    pair = TrainPair(jm, v, tm, jcfg, tcfg, seed=5)
    codes, labels, cond = _inputs(6, Z)
    batch = {"codes": codes, "labels": labels, "cond": cond}
    (_, _), jgrads = jax.value_and_grad(jtrainer._pixelcnn_loss_fn(jm), has_aux=True)(
        _jvars(v)["params"], {}, {k: jnp.asarray(x) for k, x in batch.items()}, None)
    jstate, jmetrics = jtrainer.make_train_step(jm, jcfg, donate=False)(
        pair.jstate, {k: jnp.asarray(x) for k, x in batch.items()}, jax.random.PRNGKey(0))
    _, tmetrics = trainer.make_train_step(tm, tcfg)(
        pair.tstate, {k: torch.from_numpy(x) for k, x in batch.items()})
    pair.assert_grads_match(jgrads)
    assert_metrics(tmetrics, jmetrics, ("loss", "nll_per_code"))
    pair.assert_states_match(jstate)
    assert convert.module_to_flax(tm)["params"]["cond_proj"]["kernel"].shape == (DIM, T_DIM)


def test_hier_cond_map_matches_jax():
    jm, hv, tm, x = hier_pair(seed=7)
    idx_t = np.random.default_rng(8).integers(0, ZT, (3, 2, 5)).astype(np.int32)
    want = np.asarray(jinference.hier_cond_map(hv, jnp.asarray(idx_t)))
    got = inference.hier_cond_map(tm, torch.from_numpy(idx_t)).detach().numpy()
    assert got.shape == (3, 4, 10, DIM)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_arch", ["pixelcnn", "transformer"])
def test_sample_hier_mels_with_injected_noise_matches_jax(top_arch):
    """The chain (top prior, the bottom PixelCNN conditioned on the top
    codes, the decoder) given the noise JAX draws from one key split three
    ways: the same code grids but at near-ties, and the same mels."""
    jh, hv, th, _ = hier_pair(seed=9)
    jtop, tv, ttop = _prior_pair(top_arch, ZT, False, seed=10)
    jbot, bv, tbot = _prior_pair("pixelcnn", Z, True, seed=11)
    labels = np.array([0, 3], np.int32)
    top_shape = (3, 2)
    key = jax.random.PRNGKey(12)
    w_t, w_b, w_mel = (np.asarray(a) for a in jinference.sample_hier_mels(
        jh, hv, jtop, _jvars(tv), jbot, _jvars(bv), jnp.asarray(labels), top_shape, key))
    k_t, k_b, _ = jax.random.split(key, 3)
    t_len = top_shape[0] * top_shape[1]
    if top_arch == "transformer":
        g_t = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(k_t, t), (2, ZT)))
                        for t in range(t_len)])
    else:
        g_t = jax_gumbel(k_t, t_len, 2, ZT)
    g_b = jax_gumbel(k_b, 4 * t_len, 2, Z)
    idx_t, idx_b, mels = inference.sample_hier_mels(
        th, ttop, tbot, torch.from_numpy(labels), top_shape,
        top_gumbel=torch.from_numpy(g_t), bottom_gumbel=torch.from_numpy(g_b))
    np.testing.assert_array_equal(idx_t.numpy(), w_t)  # no near-tie at this seed
    cond = np.asarray(jinference.hier_cond_map(hv, jnp.asarray(w_t)))
    b_logits = np.asarray(jbot.apply(_jvars(bv), jnp.asarray(w_b), jnp.asarray(labels),
                                     jnp.asarray(cond)))
    assert_same_draws(idx_b.numpy(), w_b, b_logits, g_b)
    assert idx_b.shape == (2, 6, 4) and mels.shape == (2, 24, 16)
    if np.array_equal(idx_b.numpy(), w_b):
        np.testing.assert_allclose(mels.numpy(), w_mel, atol=ATOL)
    assert len(np.unique(w_b)) > 4


# ---------------------------------------------------------------------------
# The CLIs end to end
# ---------------------------------------------------------------------------

TOP = ["--arch", "transformer", "--prior-dim", str(T_DIM), "--prior-layers", str(T_LAYERS),
       "--prior-heads", str(T_HEADS)]
BOTTOM = ["--arch", "pixelcnn", "--prior-dim", str(P_DIM), "--prior-layers", str(P_LAYERS)]
COMMON = ["--dim", str(DIM), "--z-dim", str(Z), "--device", "cpu"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A HierVQVAE from ``cli.main``, its transformer top prior and its
    PixelCNN bottom prior from ``cli.prior train --hier``."""
    root = tmp_path_factory.mktemp("hier_prior")
    os.makedirs(root / "corpus")
    datadir = _corpus(str(root / "corpus"))
    with contextlib.redirect_stdout(io.StringIO()):
        main.main(["--model", "hiervqvae", "--dataset", "ljspeech", "--datadir", datadir,
                   "--batch-size", "4", "--max-batches-per-epoch", "3", "--epochs", "1",
                   "--log-interval", "0", "--codebook-init", "data",
                   "--ckpt-dir", str(root / "models"), "--sampledir", str(root / "results"),
                   *COMMON])
    vq = str(root / "models" / "hiervqvae" / f"checkpoint_ljspeech_{DIM}_{Z}")
    train = ["train", "--datadir", datadir, "--vqvae-ckpt", vq, "--hier", "--batch-size", "4",
             "--max-batches-per-epoch", "3", "--lr", "3e-3", *COMMON]
    logs = {}
    for level, widths in (("top", TOP), ("bottom", BOTTOM)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            prior.main(train + ["--hier-level", level, "--epochs", "2",
                                "--ckpt-dir", str(root / level), *widths])
        logs[level] = out.getvalue()
    return root, datadir, vq, str(root / "top"), str(root / "bottom"), train, logs


def test_hier_train_writes_both_levels(chain):
    root, _, _, top, bottom, _, logs = chain
    for ckpt in (top, bottom):
        assert checkpoint.latest_step(ckpt) == 6
    meta = checkpoint.read_extra(top)
    assert meta["arch"] == "transformer" and meta["spatial_cond"] is False
    meta = checkpoint.read_extra(bottom)
    assert meta == {"epoch": 2, "arch": "pixelcnn", "prior_dim": P_DIM, "prior_layers": P_LAYERS,
                    "prior_heads": 0, "z_dim": Z, "n_classes": 10, "spatial_cond": True,
                    "cond_dim": DIM, "n_experts": 0}
    state = torch.load(os.path.join(bottom, "step_6", "state.pt"), weights_only=True)
    # 80 x 24 crops: the bottom grid is 20 x 6, conditioned on DIM channels
    assert state["params/layer_0.spatial_cond.weight"].shape == (2 * P_DIM, DIM, 1, 1)
    state = torch.load(os.path.join(top, "step_6", "state.pt"), weights_only=True)
    assert state["params/block_0.attn_qkv.weight"].shape == (3 * T_DIM, T_DIM)
    for log in logs.values():
        nll = [float(line.split("nll/code ")[1].split()[0])
               for line in log.splitlines() if line.startswith("prior epoch")]
        assert len(nll) == 2 and all(np.isfinite(nll))
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)  # the CPU ran the plain pair


def test_hier_bottom_resumes(chain, tmp_path):
    _, _, _, _, bottom, train, _ = chain
    import shutil

    for suffix in ("", "_ema", "_train"):
        shutil.copytree(bottom + suffix, str(tmp_path / "b") + suffix)
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(train + ["--hier-level", "bottom", "--epochs", "3", "--resume",
                            "--ckpt-dir", str(tmp_path / "b"), *BOTTOM])
    assert checkpoint.latest_step(str(tmp_path / "b")) == 9


def _sample_argv(vq, top, bottom, out, *extra):
    return ["sample", "--hier", "--vqvae-ckpt", vq, "--prior-ckpt", top, "--bottom-ckpt", bottom,
            "--output-dir", str(out), "--code-shape", "10", "2", "--num-samples", "2",
            "--label", "1", *TOP, "--bottom-arch", "pixelcnn", "--bottom-dim", str(P_DIM),
            "--bottom-layers", str(P_LAYERS), *COMMON, *extra]


def test_sample_hier_writes_finite_wavs(chain, tmp_path):
    from scipy.io import wavfile

    _, _, vq, top, bottom, _, _ = chain
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(_sample_argv(vq, top + "_ema", bottom + "_ema", tmp_path / "s"))
    names = sorted(os.listdir(tmp_path / "s"))
    assert names == ["hier_sample_000.wav", "hier_sample_001.wav"]
    for name in names:
        rate, wav = wavfile.read(tmp_path / "s" / name)
        # a 10 x 2 top grid: 20 x 4 bottom, 16 frames, 15 Griffin-Lim hops
        assert rate == SR and wav.shape == (15 * 256,) and np.abs(wav).max() > 0


def test_sample_hier_refuses_mismatched_checkpoints(chain, tmp_path):
    _, _, vq, top, bottom, _, _ = chain
    with pytest.raises(SystemExit, match="--bottom-ckpt"):
        prior.main(["sample", "--hier", "--vqvae-ckpt", vq, "--prior-ckpt", top,
                    "--output-dir", str(tmp_path), *TOP, *COMMON])
    # the wrong family for the bottom
    argv = _sample_argv(vq, top, bottom, tmp_path)
    argv[argv.index("--bottom-arch") + 1] = "transformer"
    with pytest.raises(SystemExit, match="arch"):
        prior.main(argv)
    # a bottom (spatially conditioned) checkpoint where the top is expected
    with pytest.raises(SystemExit, match="spatial_cond=True"):
        prior.main(["sample", "--vqvae-ckpt", vq, "--prior-ckpt", bottom, "--hier",
                    "--bottom-ckpt", bottom, "--output-dir", str(tmp_path), *BOTTOM, *COMMON])


def test_sample_hier_with_routed_transformer_levels(chain, tmp_path):
    """``--moe-experts`` reaches both transformer levels: a routed top and a
    routed, spatially conditioned bottom train, and ``sample --hier`` with
    the one flag restores both (the bottom takes it, as the JAX
    ``_bottom_args`` copies it)."""
    from scipy.io import wavfile

    _, _, vq, _, _, train, _ = chain
    routed = ["--moe-experts", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        for level in ("top", "bottom"):
            prior.main(train + ["--hier-level", level, "--epochs", "1", "--ckpt-dir",
                                str(tmp_path / level), *TOP, *routed])
    for level, spatial in (("top", False), ("bottom", True)):
        meta = checkpoint.read_extra(str(tmp_path / level))
        assert (meta["n_experts"], meta["spatial_cond"]) == (2, spatial)
    argv = _sample_argv(vq, str(tmp_path / "top"), str(tmp_path / "bottom"), tmp_path / "s",
                        *routed)
    i = argv.index("--bottom-arch")
    argv[i + 1:i + 6] = ["transformer", "--bottom-dim", str(T_DIM), "--bottom-layers",
                         str(T_LAYERS)]
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(argv)
    for i in range(2):
        rate, wav = wavfile.read(tmp_path / "s" / f"hier_sample_{i:03d}.wav")
        assert rate == SR and wav.shape == (15 * 256,) and np.abs(wav).max() > 0
    # without the flag, both routed checkpoints refuse
    i = argv.index("--moe-experts")
    del argv[i:i + 2]
    with pytest.raises(SystemExit, match="n_experts=2"):
        prior.main(argv)



def test_sample_hier_bf16(chain, tmp_path, monkeypatch):
    """``--bf16`` reaches both levels: a bf16-trained PixelCNN bottom and the
    float32-trained transformer top sample the chain in bf16, the bottom
    (built through ``bottom_args``, as the JAX ``_bottom_args`` copies the
    flag) as much as the top."""
    from scipy.io import wavfile

    _, _, vq, top, _, train, _ = chain
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(train + ["--hier-level", "bottom", "--epochs", "1", "--bf16",
                            "--ckpt-dir", str(tmp_path / "bottom"), *BOTTOM])
    built = []
    load = prior.load_prior
    monkeypatch.setattr(prior, "load_prior",
                        lambda *a: built.append(load(*a)) or built[-1])
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(_sample_argv(vq, top + "_ema", str(tmp_path / "bottom"), tmp_path / "s",
                                "--bf16"))
    assert [m.compute_dtype for m in built] == [torch.bfloat16, torch.bfloat16]
    assert [type(m).__name__ for m in built] == ["TransformerPrior", "GatedPixelCNN"]
    for i in range(2):
        rate, wav = wavfile.read(tmp_path / "s" / f"hier_sample_{i:03d}.wav")
        assert rate == SR and wav.shape == (15 * 256,) and np.abs(wav).max() > 0

def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve_argv(vq, top, bottom, *extra):
    return ["--device", "cpu", "--model", "hiervqvae", "--ckpt-dir", vq, "--dim", str(DIM),
            "--z-dim", str(Z), "--frames", "16", "--prior-ckpt", top, "--prior-arch",
            "transformer", "--prior-dim", str(T_DIM), "--prior-layers", str(T_LAYERS),
            "--prior-heads", str(T_HEADS), "--bottom-ckpt", bottom, "--bottom-prior-arch",
            "pixelcnn", "--bottom-prior-dim", str(P_DIM), "--bottom-prior-layers",
            str(P_LAYERS), *extra]


def test_serve_hier_sample_over_http(chain):
    from scipy.io import wavfile

    _, _, vq, top, bottom, _, _ = chain
    service = serve.build_service(serve.parse_args(_serve_argv(vq, top, bottom)))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
    try:
        for n in (1, 2):
            status, body = _post(url, {"n": n, "label": 1, "seed": 5})
            assert status == 200, body[:200]
            rate, wav = wavfile.read(io.BytesIO(body))
            # 16-frame windows: a 10 x 2 top grid, 20 x 4 bottom, 15 hops each
            assert rate == SR and wav.shape == (n * 15 * 256,) and np.abs(wav).max() > 0
        assert _post(url, {"n": 1, "label": 1, "seed": 5})[1] == _post(
            url, {"n": 1, "label": 1, "seed": 5})[1]
        assert _post(url, {"label": 10})[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
    with torch.inference_mode():
        mels, _ = service._sample_mels({"n": 2, "label": 0, "seed": 1})
    assert mels.shape == (2, 80, 16) and bool(torch.isfinite(mels).all())


def test_serve_hier_refuses_mismatched_priors(chain):
    _, _, vq, top, bottom, _, _ = chain
    with pytest.raises(SystemExit, match="arch"):  # the bottom as a transformer
        serve.build_service(serve.parse_args(
            _serve_argv(vq, top, bottom, "--bottom-prior-arch", "transformer")))
    with pytest.raises(SystemExit, match="arch"):  # the priors swapped
        serve.build_service(serve.parse_args(_serve_argv(vq, bottom, top)))
    with pytest.raises(SystemExit, match="--bottom-ckpt"):
        argv = _serve_argv(vq, top, bottom)
        i = argv.index("--bottom-ckpt")
        serve.build_service(serve.parse_args(argv[:i] + argv[i + 2:]))
    with pytest.raises(ValueError, match="top AND bottom"):
        service = serve.build_service(serve.parse_args(_serve_argv(vq, top, bottom)))
        service.attach_prior(service.prior)


def test_top_code_usage_collapses_as_in_jax(tmp_path):
    """The hierarchy's top level ends on a few codes after a short data-init
    run in both packages (``tests/hier_top_codes.py``; PERF.md holds its
    three-seed record at dim 64): the port does not collapse where the
    reference does not. Small widths: dim 32, 64 codes, 8 steps."""
    from hier_top_codes import top_code_usage

    usage = top_code_usage(str(tmp_path), 32, 64, 8, 4, 2, 60, seed=1)
    for name, by_tag in usage.items():
        for tag, metrics in by_tag.items():
            assert 1.0 <= metrics["perplexity_top"] < 64 / 8, (name, tag, metrics)
            assert np.isfinite(metrics["loss"]), (name, tag)
    # the two reconstructions are of one quality
    jax_recons, port_recons = (usage[n]["live"]["loss_recons"] for n in ("jax", "port"))
    assert 0.5 < port_recons / jax_recons < 2.0

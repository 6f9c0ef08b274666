"""The whole-loop generation kernel's plain versions
(ops/cuda/wavenet_gen.py) held against the JAX package's Pallas kernel in
interpret mode and against the float32 incremental path, on the CPU; its
shape predicate; ``make_generate_fn``'s dispatch; and the wrapper's refusal
to serve a non-CPU tensor without the kernel.

Tolerances: teacher logits within 2e-2 of Pallas interpret mode and of the
f32 ``incremental_forward``: the same bf16 rounding points as the Pallas
kernel, float32 sums in another order, and a rounding that lands on the
other side of a bf16 step moves that value by 2**-8 relative (the JAX
package's own kernel test holds its kernel to 2e-2). The plain sampler
against the plain teacher on the sampler's own trajectory: 1e-3 at every
step but Gumbel-max near-ties (top-2 gap below 1e-3).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.models import wavenet as jwn
from neural_sound_generation_tpu.ops.pallas import wavenet_gen as jgen
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.models import wavenet as wn
from neural_sound_generation_tpu_torch.ops.cuda import build, wavenet_gen

torch.set_num_threads(1)

# the JAX kernel test's configuration (tests/test_wavenet.py:335-350)
CFG = dict(out_channels=30, layers=4, stacks=2, residual_channels=128, gate_channels=256,
           skip_out_channels=128, cin_channels=80, upsample_scales=(2, 2), scalar_input=True)
T, HOP = 64, 4
TOL = 2e-2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((1, T // HOP, 80)).astype(np.float32)
    x = (rng.standard_normal((1, T, 1)) * 0.3).astype(np.float32)
    xs = np.array(jwn.WaveNet.shift_inputs(jnp.asarray(x), True))
    jm = jwn.WaveNet(**CFG)
    v = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0), jnp.asarray(xs),
                                                 c=jnp.asarray(c)))
    tm = wn.WaveNet(**CFG)
    tm.load_state_dict(convert.flax_to_state_dict(v))
    tm.eval()
    with torch.no_grad():
        c_up = wn._upsample_cond(tm, torch.from_numpy(c))[0]
    return jm, v, tm, c, xs, c_up, wavenet_gen.pack_weights(tm)


def test_teacher_plain_matches_pallas_interpret(setup):
    jm, v, tm, c, xs, c_up, packed = setup
    jc_up = jwn._upsample_cond(jm, v, jnp.asarray(c))[0]
    np.testing.assert_allclose(c_up.numpy(), np.asarray(jc_up), atol=1e-5)
    want = np.asarray(jgen.pallas_teacher_logits(jm, v, jc_up, jnp.asarray(xs[0, :, 0]),
                                                 interpret=True))
    got = wavenet_gen.wavenet_teacher_logits(packed, c_up, torch.from_numpy(xs[0, :, 0]))
    assert got.shape == want.shape == (T, 30)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_teacher_plain_matches_f32_incremental(setup):
    _, _, tm, c, xs, c_up, packed = setup
    ref = wn.incremental_forward(tm, torch.from_numpy(xs), torch.from_numpy(c))[0]
    got = wavenet_gen.wavenet_teacher_logits(packed, c_up, torch.from_numpy(xs[0, :, 0]))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)


def test_sampler_reproduces_itself_through_the_teacher(setup):
    """The plain sampler's samples, fed back shifted through the plain
    teacher and sampled with the same noise, come back: the card check's
    one-step consistency, here on the CPU."""
    _, _, tm, _, _, c_up, packed = setup
    gum, unif = wn.draw_noise(tm, torch.Generator().manual_seed(3), T, 1)
    samples = wavenet_gen.wavenet_generate(packed, c_up, gum[:, 0], unif[:, 0], T)
    assert samples.shape == (T,) and samples.abs().max() <= 1.0
    # random init clips many samples to +-1; enough stay inside to test
    assert int((samples.abs() < 1.0).sum()) > T // 4
    x_in = torch.nn.functional.pad(samples[:-1], (1, 0))
    logits = wavenet_gen.wavenet_teacher_logits(packed, c_up, x_in)
    again = wn.sample_mol(logits, gum[:, 0], unif[:, 0])
    top2 = torch.topk(logits[:, :10] + gum[:, 0], 2).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 1e-3
    off = (again - samples).abs() > 1e-3
    assert not bool((off & ~near_tie).any()), torch.nonzero(off & ~near_tie)


def test_sampler_matches_the_scan_sampler_in_f32(setup):
    """The kernel's sampling function against the f32 scan sampler on the
    same noise: equal within bf16 noise at every step (random init keeps
    the mixture choice far from ties over these steps, or the check says
    where it stopped)."""
    _, _, tm, c, _, c_up, packed = setup
    n = 24
    gum, unif = wn.draw_noise(tm, torch.Generator().manual_seed(4), n, 1)
    kern = wavenet_gen.wavenet_generate(packed, c_up, gum[:, 0], unif[:, 0], n)
    scan = wn.make_generate_fn(tm, n)(torch.from_numpy(c), noise=(gum, unif))[0]
    np.testing.assert_allclose(kern[:8].numpy(), scan[:8].numpy(), atol=5e-2)


GOOD = dict(out_channels=30, layers=24, stacks=4, residual_channels=128, gate_channels=256,
            skip_out_channels=128, kernel_size=3, cin_channels=80, gin_channels=-1,
            scalar_input=True)


def _shape(**kw):
    """The attributes the predicate reads, without building weights."""
    return types.SimpleNamespace(**{**GOOD, **kw})


@pytest.mark.parametrize("kw,ok", [
    (dict(), True),  # the production configuration of the kernel's docstring
    (dict(scalar_input=False, out_channels=256), False),  # categorical
    (dict(cin_channels=-1), False),  # unconditioned
    (dict(gin_channels=16), False),  # speaker-conditioned
    (dict(residual_channels=96, gate_channels=192), False),  # misaligned
    (dict(residual_channels=512, gate_channels=1024, skip_out_channels=512), False),
    # the CLI's default vocoder: R = G = 512, S = 256 is past the 10 MB cap
    (dict(residual_channels=512, gate_channels=512, skip_out_channels=256), False),
    (dict(layers=8, stacks=2), True),
    (dict(cin_channels=130), False),
])
def test_supported_predicate(kw, ok):
    """The cases of tests/test_wavenet.py:353-380, and the same answer as
    the Pallas predicate."""
    assert wavenet_gen.generate_supported(_shape(**kw), 1) is ok
    assert jgen.pallas_generate_supported(jwn.WaveNet(**{**GOOD, **kw}), 1) is ok
    assert not wavenet_gen.generate_supported(_shape(**kw), 2)


def test_production_weight_bytes():
    assert wavenet_gen._weight_bytes(_shape()) == 7_274_496  # about 7.3 MB of bf16


def test_dispatch(setup, monkeypatch):
    """Batch 1 with mels and no speaker goes to the kernel's wrapper; batch
    2, a speaker id or no mels take the scan; the assertion guards shapes
    the kernel does not take."""
    _, _, tm, c, _, _, _ = setup
    calls = []
    real = wavenet_gen.wavenet_generate

    def spy(*a, **k):
        calls.append(a[-1])
        return real(*a, **k)

    monkeypatch.setattr(wavenet_gen, "wavenet_generate", spy)
    gen = wn.make_generate_fn(tm, 8, use_kernel=True)
    ct = torch.from_numpy(c)
    out = gen(ct, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 8) and calls == [8]
    assert gen(ct.repeat(2, 1, 1), generator=torch.Generator(), batch_size=2).shape == (2, 8)
    assert gen(ct, torch.zeros(1, dtype=torch.long), torch.Generator()).shape == (1, 8)
    assert gen(None, generator=torch.Generator()).shape == (1, 8)
    assert calls == [8]
    with pytest.raises(AssertionError, match="qualify"):
        wn.make_generate_fn(wn.WaveNet(**{**CFG, "residual_channels": 96}), 8, use_kernel=True)
    # the same noise gives the same samples through the dispatch and the wrapper
    noise = wn.draw_noise(tm, torch.Generator().manual_seed(9), 8, 1)
    a = gen(ct, noise=noise)[0]
    with torch.no_grad():
        b = real(wavenet_gen.pack_weights(tm), wn._upsample_cond(tm, ct)[0],
                 noise[0][:, 0], noise[1][:, 0], 8)
    assert torch.equal(a, b)


def test_wrapper_refuses_non_cpu_tensors(setup, monkeypatch):
    """A tensor off the CPU is never served by the plain version: the
    kernel's loader refuses without CUDA, and other devices raise."""
    _, _, tm, _, xs, c_up, packed = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(wavenet_gen, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        wavenet_gen.load()
    meta = wavenet_gen.PackedWeights(
        **{f.name: (getattr(packed, f.name).to("meta")
                    if isinstance(getattr(packed, f.name), torch.Tensor)
                    else getattr(packed, f.name))
           for f in dataclasses.fields(packed)})
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_gen.wavenet_teacher_logits(meta, c_up.to("meta"),
                                           torch.zeros(T, device="meta"))
    with pytest.raises(ValueError):  # weights on another device than the input
        wavenet_gen.wavenet_teacher_logits(packed, c_up.to("meta"), torch.zeros(T))
    with pytest.raises(ValueError):  # too little conditioning
        wavenet_gen.wavenet_teacher_logits(packed, c_up[:10], torch.zeros(T))


def test_kernel_order_matvec_is_a_matvec():
    """_matvec sums in the kernel's order (16 row slices, each from zero,
    added by halving) and still computes x @ w (float64 reference, the
    tap, h, res|skip, conditioning and head products, and rows padded to a
    multiple of 16; the whole [h | taps] product and the wide conditioning
    product of all layers' columns too)."""
    g = torch.Generator().manual_seed(0)
    for rows, cols in ((256, 256), (128, 256), (384, 256), (80, 256), (80, 6144), (100, 32),
                       (7, 1024)):
        x = torch.randn(3, rows, generator=g).to(torch.bfloat16).float()
        w = torch.randn(rows, cols, generator=g).to(torch.bfloat16)
        got = wavenet_gen._matvec(x, w)
        want = (x.double() @ w.double()).float()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def test_kernel_order_is_the_halving_tree():
    """The order itself: slice sums added as (s + s+8), then (+4), (+2),
    (+1), which differs in float32 from adding them one after another."""
    x = torch.tensor([[1.0] * 16])
    w = torch.tensor([[2.0 ** 24], [1.0], [1.0], [1.0], [1.0], [1.0], [1.0], [1.0],
                      [-(2.0 ** 24)], [1.0], [1.0], [1.0], [1.0], [1.0], [1.0], [1.0]])
    # halving: slice 0 + slice 8 cancels first, so the 14 ones survive
    assert float(wavenet_gen._matvec(x, w.to(torch.bfloat16))[0, 0]) == 14.0


PROD = dict(out_channels=30, layers=24, stacks=4, residual_channels=128, gate_channels=256,
            skip_out_channels=128, cin_channels=80)


def _dims(**kw):
    """PackedWeights.dims of a shape, without building weights."""
    c = {**GOOD, **kw}
    out = c["out_channels"]
    dil = [2 ** (i % (c["layers"] // c["stacks"])) for i in range(c["layers"])]
    return {"L": c["layers"], "K": c["kernel_size"], "R": c["residual_channels"],
            "G": c["gate_channels"], "S": c["skip_out_channels"], "C": c["cin_channels"],
            "OUT": out, "OUTP": -(-out // 8) * 8, "n_mix": out // 3,
            "RD": (c["kernel_size"] - 1) * max(dil) + 1}


def test_shared_memory_fits_at_the_production_configuration():
    """A CTA of the 16-CTA cluster holds every layer's W_cur, W_res and
    W_skip slices, the head and the biases in shared memory (the chain's
    weights: 2,359,296 B over 16 CTAs, 147,456 B each), beside the
    buffers."""
    prod = wn.WaveNet(**PROD)
    packed = wavenet_gen.pack_weights(prod)
    assert packed.dims["RD"] == 65 and packed.dims["OUTP"] == 32
    assert packed.dims == _dims()
    y = wavenet_gen.kernel_layout(packed.dims)
    assert y["nc"] == wavenet_gen.CLUSTER == 16
    assert wavenet_gen.smem_bytes(packed) == y["smem"] <= wavenet_gen.SMEM_LIMIT
    assert y["res"] == y["rb"] and y["resident_layers"] == 24
    chain = 24 * (128 * 256 + 128 * 128) * 2  # W_cur + W_res, bf16
    assert chain // 16 == 147_456 and 24 * y["wcur_bytes"] + 24 * 128 * 8 * 2 == 147_456
    assert y["layer_bytes"] == 8192 and y["smem"] == 220_624


def _read_pass(blob: torch.Tensor, off: int, rps: int, q: int):
    """Pass q at byte ``off`` of one CTA's blob, read as the kernel's lanes
    read it: vector i of lane l at 16 * (i * 32 + l) bytes holds row
    (l % 16) * rps + i of chunk l // 16. -> (lo, hi) (16 * rps, 8) bf16."""
    base = off + q * rps * wavenet_gen.PASS_ROW
    v = blob[base : base + rps * wavenet_gen.PASS_ROW].view(torch.bfloat16).reshape(rps, 32, 8)
    lo = torch.empty(16 * rps, 8, dtype=torch.bfloat16)
    hi = torch.empty(16 * rps, 8, dtype=torch.bfloat16)
    for lane in range(32):
        s = lane % 16
        (lo if lane < 16 else hi)[s * rps : (s + 1) * rps] = v[:, lane]
    return lo, hi


def _floats(blob: torch.Tensor, off: int, n: int) -> torch.Tensor:
    return blob[off : off + 4 * n].view(torch.float32)


WIDE = dict(CFG, residual_channels=256, gate_channels=512, skip_out_channels=128,
            cin_channels=37, out_channels=60, layers=2, stacks=1)


@pytest.mark.parametrize("wide", [False, True])
def test_cta_slices_reassemble_the_packed_weights(setup, wide):
    """Every CTA's slices of W_cur, W_tap, W_cdot, W_res, W_skip, the head
    and the biases, read back with the kernel's lane and column maps,
    reassemble the packed weights bit for bit; padding chunks are zero. The
    tests' model, and a wider one with two passes a product, more res than
    skip columns, a head of 8 chunks and C padded from 37 to 48."""
    packed = (wavenet_gen.pack_weights(wn.WaveNet(**WIDE, generator=torch.Generator()
                                                  .manual_seed(1))) if wide else setup[-1])
    d = packed.dims
    y = wavenet_gen.kernel_layout(d)
    nc = y["nc"]
    res, stream = wavenet_gen.kernel_weights(packed)
    assert res.shape == (nc, y["rb"]) and stream.shape == (nc, y["sb"])
    L, R, G2, S, C, OUTP = d["L"], d["R"], d["G"] // 2, d["S"], d["C"], d["OUTP"]
    g8, r8, s8 = y["g8"], y["r8"], y["s8"]
    w_in = torch.zeros_like(packed.w_in)
    w_sr = torch.zeros_like(packed.w_sr)
    w_cdot = torch.zeros(C, L, 2 * G2, dtype=torch.bfloat16)
    post1 = torch.zeros_like(packed.w_post1)
    b_dil = torch.zeros_like(packed.b_dil)
    b_res = torch.zeros_like(packed.b_res)
    b_skip, b_p1 = torch.zeros_like(packed.b_skip), torch.zeros_like(packed.b_post1)
    for c in range(nc):
        blob, sblob = res[c], stream[c]
        for l in range(L):
            lay = y["layer0"] + l * y["layer_bytes"]
            tap = l * y["slayer_bytes"]
            for q in range(y["npz"]):
                a, b = c * g8 + q * 8, G2 + c * g8 + q * 8
                w_in[l, :R, a : a + 8], w_in[l, :R, b : b + 8] = _read_pass(
                    blob, lay, y["rps_r"], q)
                w_in[l, R:, a : a + 8], w_in[l, R:, b : b + 8] = _read_pass(
                    sblob, tap, y["rps_t"], q)
                lo, hi = _read_pass(sblob, tap + y["tap_bytes"], y["rps_c"], q)
                assert not lo[C:].any() and not hi[C:].any()
                w_cdot[:, l, a : a + 8], w_cdot[:, l, b : b + 8] = lo[:C], hi[:C]
                zb = _floats(blob, y["bdil"], L * y["z"]).reshape(L, y["npz"], 2, 8)
                b_dil[l, a : a + 8], b_dil[l, b : b + 8] = zb[l, q, 0], zb[l, q, 1]
            for q in range(y["nprs"]):
                lo, hi = _read_pass(blob, lay + y["wcur_bytes"], y["rps_g"], q)
                if q * 8 < r8:
                    w_sr[l, :, S + c * r8 + q * 8 : S + c * r8 + q * 8 + 8] = lo
                else:
                    assert not lo.any()
                if q * 8 < s8:
                    w_sr[l, :, c * s8 + q * 8 : c * s8 + q * 8 + 8] = hi
                else:
                    assert not hi.any()
            rb = _floats(blob, y["bres"], L * 8 * y["nprs"]).reshape(L, -1)
            b_res[l, c * r8 : (c + 1) * r8] = rb[l, :r8]
        for q in range(y["np1"]):
            for k, chunk in zip((2 * q, 2 * q + 1), _read_pass(blob, y["wp1"], y["rps_s"], q)):
                if k * 8 < s8:
                    post1[:, c * s8 + k * 8 : c * s8 + k * 8 + 8] = chunk
                else:
                    assert not chunk.any()
        post2 = torch.cat([torch.cat(_read_pass(blob, y["wp2"], y["rps_s"], q), dim=1)
                           for q in range(y["np2"])], dim=1)[:, :OUTP]
        assert torch.equal(post2, packed.w_post2)
        b_skip[c * s8 : (c + 1) * s8] = _floats(blob, y["bskip"], s8)
        b_p1[c * s8 : (c + 1) * s8] = _floats(blob, y["bp1"], s8)
        assert torch.equal(_floats(blob, y["bp2"], OUTP), packed.b_post2)
        assert torch.equal(_floats(blob, y["wfirst"], R), packed.w_first)
        assert torch.equal(_floats(blob, y["bfirst"], R), packed.b_first)
    assert torch.equal(w_in, packed.w_in) and torch.equal(w_sr, packed.w_sr)
    assert torch.equal(w_cdot.reshape(C, -1), packed.w_cdot)
    assert torch.equal(post1, packed.w_post1)
    assert torch.equal(b_dil, packed.b_dil) and torch.equal(b_res, packed.b_res)
    assert torch.equal(b_skip, packed.b_skip) and torch.equal(b_p1, packed.b_post1)


def test_split_z_matches_float64(setup):
    """The kernel's split z, the tap part plus the h part each summed in the
    kernel's order, is within 1e-5 relative of a float64 [h | taps] @ w_in,
    at every layer of the tests' model."""
    packed = setup[-1]
    R = packed.dims["R"]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(16, packed.w_in.shape[1], generator=g).to(torch.bfloat16).float()
    for layer in range(packed.dims["L"]):
        w = packed.w_in[layer]
        split = wavenet_gen._matvec(x[:, R:], w[R:]) + wavenet_gen._matvec(x[:, :R], w[:R])
        want = x.double() @ w.double()
        scale = x.double().abs() @ w.double().abs()
        assert float(((split.double() - want).abs() / scale).max()) < 1e-5


@pytest.mark.parametrize("kw,match", [
    (dict(residual_channels=96, gate_channels=192), "R = 96"),
    (dict(gate_channels=384), "G/2 = 192"),
    (dict(skip_out_channels=64), "S = 64"),
    (dict(cin_channels=0), "C=0"),
    (dict(layers=1500, stacks=1500), "buffers need"),
])
def test_layout_refusals(kw, match):
    """Shapes the kernel cannot lay out raise with the reason."""
    with pytest.raises(ValueError, match=match):
        wavenet_gen.kernel_layout(_dims(**kw), 16)


def test_layout_streams_what_does_not_fit():
    """A shape within the predicate whose slices do not fit 16 CTAs' shared
    memory keeps the rest in device memory; it is not refused."""
    kw = dict(layers=8, stacks=2, residual_channels=256, gate_channels=512,
              skip_out_channels=256)
    assert wavenet_gen.generate_supported(_shape(**kw), 1)
    y = wavenet_gen.kernel_layout(_dims(**kw), 16)
    assert y["smem"] <= wavenet_gen.SMEM_LIMIT
    assert 0 < y["resident_layers"] < 8 and y["res"] < y["rb"]


def test_launch_plan_refuses_the_cpu(setup):
    packed = setup[-1]
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_gen.launch_plan(packed)
    with pytest.raises(ValueError, match="unknown kernel"):
        wavenet_gen.launch_plan(packed, "wavenet_gen_other", "cuda")


@pytest.mark.parametrize("entry,argtypes", [
    ("wavenet_gen_launch", wavenet_gen.LAUNCH_ARGTYPES),
    ("wavenet_gen_plan", wavenet_gen.PLAN_ARGTYPES),
])
def test_ctypes_binding_matches_the_c_signature(entry, argtypes):
    """The wrapper binds each C entry with one ctypes type per parameter of
    csrc/wavenet_gen.cu's signature: pointers as c_void_p (int* as a
    pointer to c_int), ints as c_int."""
    import ctypes
    import re

    src = wavenet_gen.SOURCE.read_text()
    params = re.search(rf"int {entry}\(([^)]*)\)", src).group(1).split(",")
    want = []
    for param in params:
        decl = param.strip()
        if decl.startswith("int*"):
            want.append(ctypes.POINTER(ctypes.c_int))
        elif "*" in decl:
            want.append(ctypes.c_void_p)
        else:
            assert decl.startswith("int "), decl
            want.append(ctypes.c_int)
    assert list(argtypes) == want

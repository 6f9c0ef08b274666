"""The port's PCA (numpy and scipy) held against the JAX package's
scikit-learn-backed one on the CPU: projections, scaler statistics and
components within 1e-8, with the same signs, over tall data (sklearn's
covariance solver), short and wide data (its full SVD), constant features
and the synthetic hand's recordings."""

import warnings

import numpy as np
import pytest

from neural_sound_generation_tpu.motion import capture as jcap
from neural_sound_generation_tpu.motion import pca as jpca
from neural_sound_generation_tpu_torch.motion import capture, pca

TOL = 1e-8
CASES = {
    "tall_100x18": ((100, 18), 3, ()),
    "tall_200x18_constant": ((200, 18), 3, (1, 7)),
    "hand_600": (None, 3, ()),
    "short_64x18": ((64, 18), 3, ()),
    "short_50x6": ((50, 6), 3, ()),
    "all_components_200x5": ((200, 5), 5, ()),
    "wide_30x40_constant": ((30, 40), 5, (0,)),
}


def _data(name):
    shape, n, constant = CASES[name]
    if shape is None:
        c = capture.synthetic_controller(seed=0, n_frames=600)
        try:
            return c.drain(600), n
        finally:
            c.close()
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal(shape) * rng.uniform(0.1, 5.0, shape[1]) + rng.uniform(-3, 3)
    for j in constant:
        x[:, j] = 0.3 * (j + 1)
    return x, n


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_pca_matches_jax(name):
    x, n = _data(name)
    got = pca.run_pca(x, n)
    assert got.dtype == np.float64 and got.shape == (x.shape[0], n)
    np.testing.assert_allclose(got, jpca.run_pca(x, n), atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_projector_fit_and_project_match_jax(name):
    x, n = _data(name)
    got, want = pca.PCAProjector.fit(x, n), jpca.PCAProjector.fit(x, n)
    for field in ("mean", "scale", "components"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), atol=TOL,
                                   err_msg=field)
    rows = np.arange(got.n_components)
    largest = np.argmax(np.abs(got.components), axis=1)
    assert (got.components[rows, largest] > 0).all()  # sklearn's svd_flip
    np.testing.assert_allclose(got.project(x), want.project(x), atol=TOL)
    np.testing.assert_allclose(got.project(x[5])[0], got.project(x)[5], atol=1e-12)
    np.testing.assert_allclose(got.project(x), pca.run_pca(x, n), atol=TOL)


def test_constant_features_scale_one():
    x, n = _data("tall_200x18_constant")
    got = pca.PCAProjector.fit(x, n)
    assert got.scale[1] == 1.0 and got.scale[7] == 1.0
    np.testing.assert_array_equal(got.scale, jpca.PCAProjector.fit(x, n).scale)


@pytest.mark.parametrize("writer, reader", [(pca, jpca), (jpca, pca)], ids=["port", "jax"])
def test_save_load_interchange(tmp_path, writer, reader):
    x, n = _data("short_50x6")
    proj = writer.PCAProjector.fit(x, n)
    path = str(tmp_path / "pca.npz")
    proj.save(path)
    back = reader.PCAProjector.load(path)
    np.testing.assert_array_equal(back.project(x), proj.project(x))


def test_load_pca_from_a_recorded_csv_matches_jax(tmp_path):
    path = str(tmp_path / "cap.csv")
    c = capture.synthetic_controller(seed=2, n_frames=240)
    try:
        c.record_csv(path, 240)
    finally:
        c.close()
    got, want = pca.load_pca(path, 3), jpca.load_pca(path, 3)
    assert got.n_components == 3
    np.testing.assert_allclose(got.components, want.components, atol=TOL)
    np.testing.assert_allclose(got.scale, want.scale, atol=TOL)


def test_single_row_csv(tmp_path):
    path = str(tmp_path / "one.csv")
    np.savetxt(path, np.linspace(0.0, 1.0, 22)[None], delimiter=",")
    got = pca.load_pca(path, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # sklearn's 1-sample PCA
        want = jpca.load_pca(path, 1)
    np.testing.assert_array_equal(got.scale, want.scale)
    np.testing.assert_allclose(got.components, want.components, atol=TOL)
    np.testing.assert_array_equal(got.project(np.linspace(0.0, 1.0, 22)), [[0.0]])


def test_run_pca_np_matches_jax():
    x, _ = _data("short_50x6")
    got = pca.run_pca_np(x)
    np.testing.assert_array_equal(got, jpca.run_pca_np(x))
    cov = np.cov(got, rowvar=False)
    assert np.abs(cov - np.diag(np.diag(cov))).max() < 1e-8


def test_too_many_components_refuse():
    x, _ = _data("short_50x6")
    with pytest.raises(ValueError):
        jpca.run_pca(x, 7)
    with pytest.raises(ValueError, match="n_components=7"):
        pca.run_pca(x, 7)


def test_jax_capture_feeds_the_same_projection():
    """The JAX runtime's frames through the port's PCA give the port's
    frames' projection: the two runtimes are interchangeable inputs."""
    c = jcap.synthetic_controller(seed=9, n_frames=300)
    try:
        frames = c.drain(300)
    finally:
        c.close()
    mine = capture.synthetic_controller(seed=9, n_frames=300)
    try:
        np.testing.assert_array_equal(mine.drain(300), frames)
    finally:
        mine.close()
    np.testing.assert_allclose(pca.run_pca(frames, 3), jpca.run_pca(frames, 3), atol=TOL)

"""PCA feature reduction for motion features, in numpy and scipy.

Counterpart of ``neural_sound_generation_tpu/motion/pca.py``, whose
``run_pca``, ``PCAProjector.fit`` and ``load_pca`` call scikit-learn's
``StandardScaler`` and ``PCA``. The port does not depend on scikit-learn;
it computes the same results (float64 on the host throughout):

  * standardizing: the mean, the population variance by sklearn's
    corrected two-pass sum, and a scale of 1 for a feature sklearn deems
    constant (variance within the two-pass rounding bound
    ``n eps var + (n mean eps)^2``);
  * PCA(n): centre, then the principal axes in descending order of
    variance by sklearn's ``svd_solver="auto"`` choice, the eigenvectors of
    the covariance for tall data (n_samples >= 10 n_features, n_features
    <= 1000) and the SVD of the centred data otherwise (where sklearn would
    take a randomized SVD of a wide problem, the exact one);
  * signs as sklearn's ``svd_flip(u_based_decision=False)``: the entry of
    largest magnitude in each component row is positive.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import linalg as LA

_EPS = np.finfo(np.float64).eps


def run_pca_np(x: np.ndarray) -> np.ndarray:
    """Center + eigendecomposition variant: returns the data projected onto
    all principal axes, sorted by eigenvalue."""
    x = np.asarray(x, np.float64)
    x = x - np.mean(x, axis=0)
    cov = np.cov(x, rowvar=False)
    evals, evecs = LA.eigh(cov)
    idx = np.argsort(evals)[::-1]
    evecs = evecs[:, idx]
    return np.dot(x, evecs)


def standard_scale(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean, scale) of the columns of ``x`` (n_samples, n_features), as
    sklearn's ``StandardScaler().fit`` gives ``mean_`` and ``scale_``."""
    n = x.shape[0]
    mean = x.sum(axis=0) / n
    d = x - mean
    var = ((d**2).sum(axis=0) - d.sum(axis=0) ** 2 / n) / n
    constant = var <= n * _EPS * var + (n * mean * _EPS) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    return mean, scale


def _row_signs(vt: np.ndarray) -> np.ndarray:
    """The sign of each row's entry of largest magnitude."""
    return np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])


def principal_axes(x: np.ndarray, n_components: int):
    """(components (n_components, n_features), projected (n_samples,
    n_components)) of sklearn's ``PCA(n_components).fit_transform(x)``."""
    n, f = x.shape
    if not 0 <= n_components <= min(n, f):
        raise ValueError(
            f"n_components={n_components} must be between 0 and "
            f"min(n_samples, n_features)={min(n, f)}"
        )
    mean = np.mean(x, axis=0)
    if f <= 1000 and n >= 10 * f:
        cov = x.T @ x
        cov -= n * mean[:, None] * mean[None, :]
        cov /= n - 1
        _, evecs = np.linalg.eigh(cov)
        vt = evecs[:, ::-1].T
        vt = vt * _row_signs(vt)[:, None]
        components = np.ascontiguousarray(vt[:n_components])
        return components, (x - mean) @ components.T
    centred = x - mean
    u, s, vt = LA.svd(centred, full_matrices=False)
    signs = _row_signs(vt)
    u, vt = u * signs[None, :], vt * signs[:, None]
    return np.ascontiguousarray(vt[:n_components]), u[:, :n_components] * s[:n_components]


def run_pca(x: np.ndarray, n_components: int = 3) -> np.ndarray:
    """Standardize then PCA fit_transform. Returns (n_samples,
    n_components)."""
    x = np.asarray(x, np.float64)
    mean, scale = standard_scale(x)
    return principal_axes((x - mean) / scale, n_components)[1]


@dataclasses.dataclass
class PCAProjector:
    """Fitted standardize+project transform for streaming frames."""

    mean: np.ndarray  # (D,)
    scale: np.ndarray  # (D,)
    components: np.ndarray  # (n_components, D)

    @classmethod
    def fit(cls, x: np.ndarray, n_components: int = 3) -> "PCAProjector":
        x = np.asarray(x, np.float64)
        mean, scale = standard_scale(x)
        components, _ = principal_axes((x - mean) / scale, n_components)
        return cls(mean=mean, scale=scale, components=components)

    @property
    def n_components(self) -> int:
        return self.components.shape[0]

    def project(self, frames: np.ndarray) -> np.ndarray:
        """(N, D) or (D,) feature frames -> (N, n_components) latents."""
        frames = np.atleast_2d(np.asarray(frames, np.float64))
        x_std = (frames - self.mean) / self.scale
        return x_std @ self.components.T

    def save(self, path: str) -> None:
        np.savez(
            path, mean=self.mean, scale=self.scale, components=self.components
        )

    @classmethod
    def load(cls, path: str) -> "PCAProjector":
        data = np.load(path)
        return cls(
            mean=data["mean"], scale=data["scale"], components=data["components"]
        )


def load_pca(csv_path: str, n_components: int = 3) -> PCAProjector:
    """Fit a projector from a recorded joint-angle CSV, over frames (one
    row a frame)."""
    data = np.genfromtxt(csv_path, delimiter=",")
    if data.ndim == 1:
        data = data[None, :]
    return PCAProjector.fit(data, n_components)

"""Codebook / embedding visualization.

Counterpart of ``neural_sound_generation_tpu/utils/visualize.py``
(``visualize_embedding``, src/util.py:78-83): the reference projects the
VQ codebook to 2-D with UMAP and scatters it; the default projector here,
as in JAX, is PCA, computed in numpy by ``motion.pca.principal_axes`` with
scikit-learn's component signs (the port does not depend on
scikit-learn). matplotlib is imported when a plot is drawn, not before.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from neural_sound_generation_tpu_torch.motion.pca import principal_axes


def project_codebook_2d(
    codebook: np.ndarray, projector: Optional[Callable] = None
) -> np.ndarray:
    """(K, D) codebook -> (K, 2) scatter coordinates."""
    codebook = np.asarray(codebook, np.float64)
    if projector is not None:
        return np.asarray(projector(codebook))
    return principal_axes(codebook, 2)[1]


def visualize_embedding(
    codebook: np.ndarray,
    out_path: str,
    projector: Optional[Callable] = None,
    title: str = "codebook",
):
    """Write a 2-D scatter of the codebook to ``out_path`` (png). Raises
    ``ImportError`` naming matplotlib where it is not installed."""
    coords = project_codebook_2d(codebook, projector)
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("visualize_embedding needs matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(coords[:, 0], coords[:, 1], s=8, alpha=0.7)
    ax.set_title(f"{title} ({codebook.shape[0]} codes)")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return coords

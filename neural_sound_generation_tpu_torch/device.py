"""Device selection and float32 precision for the whole port.

Every entry point takes a ``device`` argument. ``None`` means the CUDA card:
with no card present that raises, and nothing carries on quietly on the
CPU. The CPU runs only when a caller names it (``device="cpu"``), as the
tests do. Under a data-parallel process group (``parallel.distributed``)
``None`` and a bare ``"cuda"`` mean this rank's card,
``cuda:{LOCAL_RANK % device_count}``, which is made the current device
before any tensor, kernel build or generator exists on it.

Precision: PyTorch runs float32 matrix products in full float32 by default,
but cuDNN runs float32 convolutions in TF32 (about three decimal digits).
The port sets both switches to full float32. The JAX package, which is the
reference, computes its convolutions and matrix products in float32 on the
CPU where the tests hold the port against it, and the nearest-code argmin
downstream of the encoder flips on small changes in its input. TF32 would
move the encoder's output by about 1e-3 relative and turn those flips from
rare near-ties into routine disagreements. Serving at these widths is not
bound by convolution throughput, so the exact choice costs little.
"""

from __future__ import annotations

import torch

from neural_sound_generation_tpu_torch.parallel import distributed


def set_full_float32() -> None:
    """Full-precision float32 for matrix products and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` -> CUDA (this rank's
    card under a process group), or raise."""
    set_full_float32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        if device is None:
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.index is None and distributed.world_size() > 1:
        dev = torch.device("cuda", distributed.local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev

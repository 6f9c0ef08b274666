"""The harness's spans and counters around the calls into the port's layers.

Nothing here changes what a call does or waits for the device: a probe
records the shapes a kernel's wrapper was handed and the host time a call
took, while ``recording`` is on. The port's own modules are left as they
are on disk; the wrappers are set on the loaded modules for one process.
"""

from __future__ import annotations

import time


class Probes:
    def __init__(self):
        self.recording = False
        self.vq_calls: list[tuple[int, int, int]] = []  # (N, K, D) a search
        self.adam_calls: list[tuple[int, int, bool]] = []  # (n, moment bytes, ema)
        self.spans: dict[str, list[float]] = {}  # host seconds a call, by span name
        self.kept: dict[str, list] = {}  # what each call returned, by span name
        self.first_indices = None  # what the first search returned, once asked for
        self.keep_indices = False
        self._undo = []

    def clear(self) -> None:
        self.vq_calls.clear()
        self.adam_calls.clear()
        self.spans.clear()
        self.kept.clear()

    def _patch(self, owner, attr: str, wrapper) -> None:
        original = getattr(owner, attr)
        setattr(owner, attr, wrapper(original))
        self._undo.append((owner, attr, original))

    def install_kernels(self) -> None:
        """Count kernel 1's searches and kernel 3's updates, with shapes."""
        from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel
        from neural_sound_generation_tpu_torch.training import train_state

        def vq(original):
            def nearest_codebook_indices(inputs_flat, codebook, *a, **kw):
                if self.recording:
                    self.vq_calls.append((int(inputs_flat.shape[0]), int(codebook.shape[0]),
                                          int(codebook.shape[1])))
                out = original(inputs_flat, codebook, *a, **kw)
                if self.keep_indices and self.first_indices is None:
                    self.first_indices = (out[0] if isinstance(out, tuple) else out).clone()
                return out
            return nearest_codebook_indices

        def adam(original):
            def fused_adam_update(flat_g, flat_p, m, v, ema, scalars, **kw):
                if self.recording:
                    self.adam_calls.append((int(flat_p.numel()), int(m.element_size()),
                                            ema is not None))
                return original(flat_g, flat_p, m, v, ema, scalars, **kw)
            return fused_adam_update

        self._patch(vq_kernel, "nearest_codebook_indices", vq)
        self._patch(train_state, "fused_adam_update", adam)

    def span(self, owner, attr: str, name: str, keep=None) -> None:
        """Time every call of ``owner.attr`` on the host clock (no sync);
        ``keep(out)`` keeps a part of what each call returned under the same
        name (a device tensor, read once the window has closed)."""

        def wrap(original):
            def timed(*args, **kw):
                t0 = time.perf_counter()
                out = original(*args, **kw)
                if self.recording:
                    self.spans.setdefault(name, []).append(time.perf_counter() - t0)
                    if keep is not None:
                        self.kept.setdefault(name, []).append(keep(out))
                return out
            return timed

        self._patch(owner, attr, wrap)

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, original = self._undo.pop()
            setattr(owner, attr, original)

"""Dynamic loss scaler of the PyTorch port (counterpart of
incubator_mxnet_tpu/contrib/amp/loss_scaler.py).

Needed for float16 training (gradients underflow below ~6e-8); bfloat16
shares float32's exponent range, so `amp.scale_loss` with a bf16 target
passes the loss through with scale 1.
"""
from __future__ import annotations


class LossScaler:
    """Multiply the loss by `loss_scale`; after each backward, check the
    gradients for inf/nan: on overflow halve the scale (not below 1) and
    skip the step, after `scale_window` clean steps double it (ref:
    LossScaler of the reference amp)."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0

    def update(self, overflow: bool) -> None:
        old = self.loss_scale
        if overflow:
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
        if self.loss_scale != old:
            self._note_transition(old, overflow)

    def _note_transition(self, old, overflow):
        """A change of scale: a back-off (an overflow) or a growth (a
        window of clean steps).  The JAX package hands it to its telemetry
        (an event counter and the flight recorder), best-effort; the port
        has no telemetry yet (ROADMAP.md, Queue 1 item 9), so this emits
        nothing."""

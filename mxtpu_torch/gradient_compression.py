"""2-bit gradient compression with error feedback (counterpart of
``mxtpu/gradient_compression.py``; ref: src/kvstore/gradient_compression.h).

Per element the incoming gradient is added to a persistent residual;
elements whose residual reaches +threshold or -threshold send that value
(a 2-bit code: 0 nothing, 1 +threshold, 2 -threshold, four codes a byte,
the first in the low bits) and have it subtracted from the residual, so
the quantization error feeds back into later pushes. The packing is the
reference's byte for byte. It applies to the ``dist_*`` store's push,
whose payload crosses between processes.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["GradientCompression"]


class GradientCompression:
    """Stateful quantizer: one residual buffer per key."""

    def __init__(self, type="2bit", threshold=0.5, **_ignored):
        if type != "2bit":
            raise MXNetError("unsupported gradient compression type %r "
                             "(the reference supports only 2bit too)" % type)
        self.threshold = float(threshold)
        if self.threshold <= 0:
            raise MXNetError("threshold must be positive")
        self._residuals = {}

    def quantize(self, key, grad):
        """Add ``grad`` to ``key``'s residual and return ``(packed uint8
        codes, number of elements)``; the residual moves in place."""
        g = np.asarray(grad, np.float32).ravel()
        r = self._residuals.get(key)
        if r is None or r.shape != g.shape:
            r = np.zeros_like(g)
        r = r + g
        pos = r >= self.threshold
        neg = r <= -self.threshold
        codes = np.zeros(g.shape, np.uint8)
        codes[pos] = 1
        codes[neg] = 2
        r = r - pos * self.threshold + neg * self.threshold
        self._residuals[key] = r
        n = g.size
        codes = np.pad(codes, (0, (-n) % 4))
        packed = (codes[0::4] | (codes[1::4] << 2) | (codes[2::4] << 4)
                  | (codes[3::4] << 6))
        return packed, n

    def dequantize(self, packed, n, shape=None):
        """The codes back as {-threshold, 0, +threshold} float32."""
        p = np.asarray(packed, np.uint8)
        codes = np.empty(p.size * 4, np.uint8)
        codes[0::4] = p & 3
        codes[1::4] = (p >> 2) & 3
        codes[2::4] = (p >> 4) & 3
        codes[3::4] = (p >> 6) & 3
        codes = codes[:n]
        out = np.zeros(n, np.float32)
        out[codes == 1] = self.threshold
        out[codes == 2] = -self.threshold
        return out.reshape(shape) if shape is not None else out

    def get_compression_factor(self):
        """Size reduction against float32: 16."""
        return 16

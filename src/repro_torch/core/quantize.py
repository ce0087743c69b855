"""Global b-bit impact quantization (paper §2.1, §4.3).

Each real-valued contribution C(t, d) is mapped to an integer impact in
[1, 2^b - 1] by a single global linear map — the paper's construction for the
JASS index (8 bits Gov2, 9 bits ClueWeb09B). Quantization is monotone, so
integer-space rankings approximate float-space rankings with fidelity set by
``bits``; safe early-termination proofs in the engine are exact *with respect
to the quantized scores*, matching the paper's "non-safe, fidelity set by the
quantization level" framing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Quantizer", "fit_quantizer"]


@dataclasses.dataclass(frozen=True)
class Quantizer:
    bits: int
    scale: float  # impact = ceil(score * scale), clipped to [1, 2^bits - 1]

    @property
    def max_impact(self) -> int:
        return (1 << self.bits) - 1

    def quantize(self, scores: np.ndarray) -> np.ndarray:
        q = np.ceil(scores.astype(np.float64) * self.scale)
        return np.clip(q, 1, self.max_impact).astype(np.int32)

    def dequantize(self, impacts: np.ndarray) -> np.ndarray:
        return impacts.astype(np.float32) / np.float32(self.scale)


def fit_quantizer(scores: np.ndarray, bits: int = 8) -> Quantizer:
    m = float(scores.max()) if scores.size else 1.0
    m = max(m, 1e-9)
    return Quantizer(bits=bits, scale=((1 << bits) - 1) / m)

"""Shared quantization enums (strategy / format).

Mirrors the reference enums at
``/root/reference/src/onnx_quantize/core/_qconfig.py:31-43``. Split into their own
module so the numerics core does not depend on the pydantic config layer.
"""

from __future__ import annotations

import enum

__all__ = ["QuantizationStrategy", "QFormat"]


class QuantizationStrategy(str, enum.Enum):
    """How qparams are shared across a weight tensor."""

    TENSOR = "tensor"
    CHANNEL = "channel"
    GROUP = "group"


class QFormat(str, enum.Enum):
    """Quantized-execution format.

    QDQ: weights stored quantized, dequantized (fused) into fp matmul — the
    accuracy-parity path. QLINEAR: full int8 compute with requantized outputs —
    the integer tensor-core path.
    """

    QDQ = "qdq"
    QLINEAR = "qlinear"

"""Weight-only 8-bit matmul with the dequant affine folded onto the product.

    x @ ((w - zp) * s) == (x @ w - rowsum(x) * zp) * s

for per-channel or per-tensor (s, zp). The dot then consumes the raw integer
weight, whose convert XLA fuses into the GEMM on the GPU, so no dequantized
(K, N) float copy is ever written — where the oracle's dequantize-then-dot
materializes one. Raw 8-bit codes are exact in bf16, and the affine runs in
f32 on the (M, N) product.
"""

from __future__ import annotations

import jax.numpy as jnp

from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.nn.qtensor import QTensor
from onnx_quantize_tpu.ops.reference import qdq_epilogue, weight_qparams_2d

__all__ = ["w8_fold_supported", "w8_folded_matmul"]


def w8_fold_supported(qt: QTensor) -> bool:
    m = qt.meta
    return (
        not m.packed
        and m.fmt == QFormat.QDQ
        and m.qt.bitwidth == 8
        and m.strat in (QuantizationStrategy.CHANNEL, QuantizationStrategy.TENSOR)
        and m.input_quant.mode == "none"
        and getattr(qt.data, "ndim", 2) == 2
    )


def w8_folded_matmul(x, qt: QTensor, bias=None):
    """One weight-only 8-bit site; same semantics as the oracle's QDQ path."""
    y = jnp.matmul(x, jnp.asarray(qt.data).astype(x.dtype),
                   preferred_element_type=jnp.float32)
    scale, zp = weight_qparams_2d(qt)  # scalar or (N,)
    xs = jnp.sum(x.astype(jnp.float32), axis=-1, keepdims=True)
    return qdq_epilogue((y - xs * zp) * scale, qt, bias)

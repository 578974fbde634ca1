"""Reference (pure-jnp) quantized execution semantics.

These are the executable semantics of every quantized matmul variant the
framework emits — the analogue of the reference's ONNXScript qfunction library
(``/root/reference/src/onnx_quantize/qfunctions/_qdq/qmatmul.py:9-267``,
``_qlinear/qmatmul.py:7-32``), which its tests also call eagerly on numpy arrays
(SURVEY.md §3.5). Pallas kernels in :mod:`onnx_quantize_tpu.ops` must match
these functions bit-for-bit (tested in interpret mode); XLA already fuses the
dequant into the matmul on this path, so it is also the correct fallback on CPU.

Semantics:
  * QDQ: weights dequantized into an fp matmul; activations fake-quantized
    (static scales) or dynamically quantized per tensor (uint8 asymmetric).
  * QLINEAR: input statically quantized, int32 accumulation with zero-point
    corrections, requantized output with output scale/zp, then dequantized.
"""

from __future__ import annotations

import jax.numpy as jnp

from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.core.numerics import compute_qparams
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec, QBias, QTensor, unpack_k_pairs

__all__ = [
    "unpack_weight",
    "dequantize_weight",
    "static_fake_quant",
    "dynamic_quantize_params",
    "quantized_matmul_jnp",
]


def unpack_weight(qt: QTensor) -> jnp.ndarray:
    """Unpack a QTensor's data to its (K, N) integer container values."""
    K, N = qt.meta.shape
    if qt.meta.packed:
        return unpack_k_pairs(
            qt.data, K, signed=qt.meta.qt.is_signed, pack_group=qt.meta.pack_group
        )
    return qt.data


def weight_qparams_2d(qt: QTensor):
    """(scale, zp) as f32 in the logical layout (scalar / (N,) / (G, N)).

    Accepts the engine's pre-baked kernel layout ((G_pad/2, 2, N) padded group
    pairs — see ``engine.prepare_kernel_scales``) and slices it back to the
    real (G, N) rows so the oracle stays layout-agnostic."""
    scale = jnp.asarray(qt.scale, jnp.float32)
    zp = jnp.asarray(qt.zero_point, jnp.float32)
    if scale.ndim == 3:
        K, N = qt.meta.shape
        G = -(-K // qt.meta.pack_group)
        scale = scale.reshape(-1, N)[:G]
        zp = zp.reshape(-1, N)[:G]
    return scale, zp


def dequantize_weight(qt: QTensor) -> jnp.ndarray:
    """Dequantize a QTensor to (K, N) float32 per its strategy."""
    K, N = qt.meta.shape
    w = unpack_weight(qt).astype(jnp.float32)
    scale, zp = weight_qparams_2d(qt)
    strat = qt.meta.strat

    if strat == QuantizationStrategy.TENSOR:
        return (w - zp) * scale
    if strat == QuantizationStrategy.CHANNEL:
        return (w - zp[None, :]) * scale[None, :]
    # GROUP: scale is (n_groups, N); K-rows grouped contiguously.
    n_groups = scale.shape[0]
    gs = K // n_groups
    w = w.reshape(n_groups, gs, N)
    dq = (w - zp[:, None, :]) * scale[:, None, :]
    return dq.reshape(K, N)


def static_fake_quant(x, scale, zero_point, spec: ActQuantSpec):
    """QuantizeLinear -> DequantizeLinear with static qparams (QDQ act path)."""
    qt = spec.quant_type
    qmin, qmax = qt.qrange(spec.symmetric, spec.reduce_range)
    scale = jnp.asarray(scale, jnp.float32)
    zp = jnp.asarray(zero_point, jnp.float32)
    q = jnp.clip(jnp.round(x / scale) + zp, qmin, qmax)
    return (q - zp) * scale


def dynamic_quantize_params(x, spec: ActQuantSpec):
    """Per-tensor dynamic qparams (ONNX DynamicQuantizeLinear semantics)."""
    rmin = jnp.minimum(jnp.min(x), 0.0)
    rmax = jnp.maximum(jnp.max(x), 0.0)
    return compute_qparams(
        rmin, rmax, spec.quant_type, spec.symmetric, spec.reduce_range,
        scale_dtype=jnp.float32, zp_dtype=jnp.float32,
    )


def _apply_input_quant(x, qt: QTensor):
    spec = qt.meta.input_quant
    if spec.mode == "none":
        return x
    if spec.mode == "static":
        return static_fake_quant(x, qt.input_scale, qt.input_zero_point, spec)
    # dynamic
    scale, zp = dynamic_quantize_params(x, spec)
    return static_fake_quant(x, scale, zp, spec)


def _apply_output_quant(y, qt: QTensor):
    spec = qt.meta.output_quant
    if spec.mode == "none":
        return y
    if spec.mode == "static":
        return static_fake_quant(y, qt.output_scale, qt.output_zero_point, spec)
    scale, zp = dynamic_quantize_params(y, spec)
    return static_fake_quant(y, scale, zp, spec)


def _bias_value(bias):
    if bias is None:
        return None
    if isinstance(bias, QBias):
        return bias.dequantize()
    return bias


def _qdq_matmul(x, qt: QTensor, bias):
    # Weight-only sites run the dot in the caller's compute dtype (f32 on the
    # oracle/test paths — identity there; bf16 in the engine, where this path
    # serves prefill-scale M for W4 and a f32 dot would run the tensor cores
    # at a fraction of their bf16 rate). Sites with activation QDQ keep the full f32
    # chain: the fake-quantized operand IS the semantics there, and rounding
    # it to bf16 would deviate from the reference's W8A8 numerics.
    weight_only = qt.meta.input_quant.mode == "none"
    compute_dtype = x.dtype if weight_only else jnp.float32
    w = dequantize_weight(qt).astype(compute_dtype)
    x = _apply_input_quant(x, qt).astype(compute_dtype)
    y = jnp.matmul(x, w, preferred_element_type=jnp.float32)
    b = _bias_value(bias)
    if b is not None:
        y = y + b
    return _apply_output_quant(y, qt)


def _qlinear_matmul(x, qt: QTensor, bias):
    """Full-integer compute path (QLinearMatMul / ms QGemm semantics)."""
    w_spec = qt.meta
    w_qt = w_spec.qt
    in_spec = w_spec.input_quant
    in_qt = in_spec.quant_type

    # Quantize the input with the calibrated static qparams.
    x_scale = jnp.asarray(qt.input_scale, jnp.float32)
    x_zp = jnp.asarray(qt.input_zero_point, jnp.int32)
    iqmin, iqmax = in_qt.qrange(in_spec.symmetric, in_spec.reduce_range)
    x_q = jnp.clip(jnp.round(x / x_scale).astype(jnp.int32) + x_zp, iqmin, iqmax)

    w_q = unpack_weight(qt).astype(jnp.int32)
    w_scale = jnp.asarray(qt.scale, jnp.float32)
    w_zp = jnp.asarray(qt.zero_point, jnp.int32)

    # int32 accumulation with zero-point corrections.
    if w_spec.strat == QuantizationStrategy.TENSOR:
        w_centered = w_q - w_zp
    else:  # CHANNEL (QLinear forbids GROUP)
        w_centered = w_q - w_zp[None, :]
    acc = jnp.matmul(
        (x_q - x_zp).astype(jnp.int32), w_centered, preferred_element_type=jnp.int32
    )

    if bias is not None:
        assert isinstance(bias, QBias), "QLinear Gemm requires an int32-quantized bias."
        acc = acc + jnp.asarray(bias.data, jnp.int32)

    # Requantize to the output dtype, then dequantize back to fp.
    out_spec = w_spec.output_quant
    out_qt = out_spec.quant_type
    oqmin, oqmax = out_qt.qrange(out_spec.symmetric, out_spec.reduce_range)
    y_scale = jnp.asarray(qt.output_scale, jnp.float32)
    y_zp = jnp.asarray(qt.output_zero_point, jnp.float32)
    if w_spec.strat == QuantizationStrategy.TENSOR:
        requant = x_scale * w_scale / y_scale
    else:
        requant = x_scale * w_scale[None, :] / y_scale
    y_q = jnp.clip(jnp.round(acc.astype(jnp.float32) * requant) + y_zp, oqmin, oqmax)
    return (y_q - y_zp) * y_scale


def qdq_prologue(x, qt: QTensor):
    """Input-side QDQ activation handling (shared with the Pallas path)."""
    return _apply_input_quant(x, qt)


def qdq_epilogue(y, qt: QTensor, bias):
    """Bias add + output-side QDQ activation handling (shared with Pallas)."""
    b = _bias_value(bias)
    if b is not None:
        y = y + b
    return _apply_output_quant(y, qt)


def quantized_matmul_jnp(x, qt: QTensor, bias=None):
    """Execute one quantized linear site with pure-jnp semantics."""
    if qt.meta.fmt == QFormat.QLINEAR:
        return _qlinear_matmul(x, qt, bias)
    return _qdq_matmul(x, qt, bias)

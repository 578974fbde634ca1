"""Per-variant quantized-matmul semantics tests.

The analogue of the reference's eager qfunction tests
(``test/qfunctions/qdq/test_qmatmul.py:33-75``): every execution variant checked
against a numpy reference composed from the numerics core, and loosely against
the fp original.
"""

import numpy as np
import pytest

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.core.numerics import dequantize
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec, QBias, make_qtensor
from onnx_quantize_tpu.ops.reference import (
    dequantize_weight,
    dynamic_quantize_params,
    quantized_matmul_jnp,
)

from ..helpers import truncated_normal


def _make_weights_only_qt(rng, K=32, N=16, qt=QuantType.QInt8,
                          strategy=QuantizationStrategy.CHANNEL, gs=-1,
                          fmt=QFormat.QDQ, **extra):
    w = truncated_normal(rng, (K, N))
    q, s, zp = rtn_quantize(w, qt, strategy, gs, False, False)
    qtensor = make_qtensor(
        q, s, zp, quant_type=qt, strategy=strategy, group_size=gs,
        symmetric=False, reduce_range=False, fmt=fmt, **extra,
    )
    dq = np.asarray(dequantize(q, s, zp, preprocess=True, strategy=strategy, group_size=gs))
    return w, qtensor, dq


@pytest.mark.parametrize("qt", [QuantType.QInt8, QuantType.QUInt8, QuantType.QInt4, QuantType.QUInt4])
@pytest.mark.parametrize("strategy, gs", [
    (QuantizationStrategy.TENSOR, -1),
    (QuantizationStrategy.CHANNEL, -1),
    (QuantizationStrategy.GROUP, 8),
])
def test_dequantize_weight_matches_numerics_core(rng, qt, strategy, gs):
    w, qtensor, dq = _make_weights_only_qt(rng, qt=qt, strategy=strategy, gs=gs)
    np.testing.assert_allclose(np.asarray(dequantize_weight(qtensor)), dq, atol=1e-6)


def test_weights_only_qdq_matmul(rng):
    w, qtensor, dq = _make_weights_only_qt(rng)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    y = np.asarray(quantized_matmul_jnp(x, qtensor))
    np.testing.assert_allclose(y, x @ dq, atol=1e-5)
    np.testing.assert_allclose(y, x @ w, atol=5e-2)


def test_static_input_qdq(rng):
    in_spec = ActQuantSpec(mode="static", dtype="uint8")
    x = rng.standard_normal((4, 32)).astype(np.float32)
    in_scale = np.float32((np.max(x) - np.min(x)) / 255)
    in_zp = np.float32(np.round(np.clip(-np.min(x) / in_scale, 0, 255)))
    w, qtensor, dq = _make_weights_only_qt(
        rng, input_quant=in_spec, input_scale=in_scale, input_zero_point=in_zp
    )
    y = np.asarray(quantized_matmul_jnp(x, qtensor))
    x_fq = (np.clip(np.round(x / in_scale) + in_zp, 0, 255) - in_zp) * in_scale
    np.testing.assert_allclose(y, x_fq @ dq, atol=1e-5)
    np.testing.assert_allclose(y, x @ w, atol=1e-1)


def test_static_input_qdq_bf16_stream_keeps_f32_chain(rng):
    """On a bf16 activation stream, sites WITH activation QDQ must still run
    the reference f32 chain (the fake-quantized operand IS the semantics);
    only weight-only sites take the caller's-dtype fast dot. Guards the
    weight_only gate in ``_qdq_matmul``."""
    import jax.numpy as jnp

    in_spec = ActQuantSpec(mode="static", dtype="uint8")
    x = rng.standard_normal((4, 32)).astype(np.float32)
    in_scale = np.float32((np.max(x) - np.min(x)) / 255)
    in_zp = np.float32(np.round(np.clip(-np.min(x) / in_scale, 0, 255)))
    w, qtensor, dq = _make_weights_only_qt(
        rng, input_quant=in_spec, input_scale=in_scale, input_zero_point=in_zp
    )
    y_bf16 = np.asarray(
        quantized_matmul_jnp(jnp.asarray(x, jnp.bfloat16), qtensor), np.float32
    )
    # Exact f32-chain match: the only deviation allowed is the bf16 rounding
    # of x itself before the (f32) fake-quant — which the QDQ grid absorbs
    # for most entries; pin a tight tolerance far below bf16 dot error.
    x_bf = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    x_fq = (np.clip(np.round(x_bf / in_scale) + in_zp, 0, 255) - in_zp) * in_scale
    np.testing.assert_allclose(y_bf16, x_fq @ dq, atol=1e-5)


def test_static_output_qdq(rng):
    out_spec = ActQuantSpec(mode="static", dtype="uint8")
    w0 = truncated_normal(np.random.default_rng(1), (32, 16))
    x = rng.standard_normal((4, 32)).astype(np.float32)
    y_ref = x @ w0
    o_scale = np.float32((y_ref.max() - y_ref.min()) / 255)
    o_zp = np.float32(np.round(np.clip(-y_ref.min() / o_scale, 0, 255)))
    w, qtensor, dq = _make_weights_only_qt(
        rng, output_quant=out_spec, output_scale=o_scale, output_zero_point=o_zp
    )
    y = np.asarray(quantized_matmul_jnp(x, qtensor))
    y_mm = x @ dq
    y_fq = (np.clip(np.round(y_mm / o_scale) + o_zp, 0, 255) - o_zp) * o_scale
    np.testing.assert_allclose(y, y_fq, atol=1e-5)


def test_dynamic_input_qdq(rng):
    in_spec = ActQuantSpec(mode="dynamic", dtype="uint8")
    w, qtensor, dq = _make_weights_only_qt(rng, input_quant=in_spec)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    y = np.asarray(quantized_matmul_jnp(x, qtensor))
    # Compose the DynamicQuantizeLinear reference by hand.
    scale, zp = dynamic_quantize_params(x, in_spec)
    scale, zp = np.float32(scale), np.float32(zp)
    x_fq = (np.clip(np.round(x / scale) + zp, 0, 255) - zp) * scale
    np.testing.assert_allclose(y, x_fq @ dq, atol=1e-5)


def test_qdq_bias(rng):
    w, qtensor, dq = _make_weights_only_qt(rng)
    bias = truncated_normal(rng, (16,))
    q, s, zp = rtn_quantize(
        bias.reshape(-1, 1), QuantType.QInt8, QuantizationStrategy.TENSOR, -1, False, False
    )
    qb = QBias(data=q.reshape(-1), scale=s, zero_point=zp, quant_type="int8")
    x = rng.standard_normal((4, 32)).astype(np.float32)
    y = np.asarray(quantized_matmul_jnp(x, qtensor, qb))
    b_dq = (q.reshape(-1).astype(np.float32) - np.float32(zp)) * np.float32(s)
    np.testing.assert_allclose(y, x @ dq + b_dq, atol=1e-5)


@pytest.mark.parametrize("strategy", [QuantizationStrategy.TENSOR, QuantizationStrategy.CHANNEL])
def test_qlinear_int_path_matches_fp_composition(rng, strategy):
    """int32-accumulation path == quantize/dequantize fp composition."""
    K, N = 32, 16
    w = truncated_normal(rng, (K, N))
    q, s, zp = rtn_quantize(w, QuantType.QInt8, strategy, -1, True, False)
    x = rng.standard_normal((4, K)).astype(np.float32)

    in_scale = np.float32((np.max(x) - np.min(x)) / 255)
    in_zp = np.float32(128)
    dq = np.asarray(dequantize(q, s, zp, preprocess=True, strategy=strategy, group_size=-1))
    y_ref = x @ w
    o_scale = np.float32((y_ref.max() - y_ref.min()) / 255)
    o_zp = np.float32(round(float(np.clip(-y_ref.min() / o_scale, 0, 255))))

    qtensor = make_qtensor(
        q, s, zp, quant_type=QuantType.QInt8, strategy=strategy, group_size=-1,
        symmetric=True, reduce_range=False, fmt=QFormat.QLINEAR,
        input_quant=ActQuantSpec(mode="static", dtype="uint8"),
        output_quant=ActQuantSpec(mode="static", dtype="uint8"),
        input_scale=in_scale, input_zero_point=in_zp,
        output_scale=o_scale, output_zero_point=o_zp,
    )
    y = np.asarray(quantized_matmul_jnp(x, qtensor))

    # Compose in fp: quantize x, int matmul via centered values, requantize.
    x_q = np.clip(np.round(x / in_scale) + in_zp, 0, 255)
    acc = (x_q - in_zp) @ (q.astype(np.int32) - (np.asarray(zp) if strategy == QuantizationStrategy.TENSOR else np.asarray(zp)[None, :]))
    s_w = np.asarray(s) if strategy == QuantizationStrategy.TENSOR else np.asarray(s)[None, :]
    y_q = np.clip(np.round(acc * (in_scale * s_w / o_scale)) + o_zp, 0, 255)
    y_comp = (y_q - o_zp) * o_scale
    np.testing.assert_allclose(y, y_comp, atol=1e-4)
    # And loosely against the fp original.
    np.testing.assert_allclose(y, y_ref, atol=1e-1)

import numpy as np
import pytest

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec, make_qtensor
from onnx_quantize_tpu.ops.dispatch import select_path
from onnx_quantize_tpu.ops.reference import (
    dequantize_weight,
    dynamic_quantize_params,
    quantized_matmul_jnp,
    static_fake_quant,
)


def _w8a8_qt(rng, K=64, N=128, qt_type=QuantType.QInt8,
             strategy=QuantizationStrategy.CHANNEL, gs=-1):
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    q, s, zp = rtn_quantize(w, qt_type, strategy, gs, True, False)
    return w, make_qtensor(
        q, s, zp, quant_type=qt_type, strategy=strategy, group_size=gs,
        symmetric=True, reduce_range=False, fmt=QFormat.QDQ,
        input_quant=ActQuantSpec(mode="dynamic", dtype="int8", symmetric=True),
    )


@pytest.mark.parametrize("qt_type", [QuantType.QInt8, QuantType.QUInt8])
@pytest.mark.parametrize("strategy, gs, K", [
    (QuantizationStrategy.CHANNEL, -1, 64),
    (QuantizationStrategy.CHANNEL, -1, 100),
    (QuantizationStrategy.GROUP, 16, 64),
])
def test_w8a8_matches_fake_quant_semantics(rng, qt_type, strategy, gs, K):
    """The A8 oracle on 8-bit weights: int8 fake-quant of x, fp matmul on the
    dequantized weights, close to the fp original."""
    w, qt = _w8a8_qt(rng, K=K, qt_type=qt_type, strategy=strategy, gs=gs)
    x = rng.standard_normal((6, K)).astype(np.float32)
    y = np.asarray(quantized_matmul_jnp(x, qt))
    scale, zp = dynamic_quantize_params(x, qt.meta.input_quant)
    x_fq = np.asarray(static_fake_quant(x, scale, zp, qt.meta.input_quant))
    np.testing.assert_allclose(y, x_fq @ np.asarray(dequantize_weight(qt)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y, x @ w, atol=0.1)


def test_dispatch_keeps_w8a8_on_the_oracle(rng):
    """The folded 8-bit path is weight-only: A8 sites stay on the oracle."""
    _, qt = _w8a8_qt(rng)
    assert select_path((4, 1), qt, backend="gpu", impl="auto") == "jnp"


def test_convert_covers_symmetric_int8(rng):
    from onnx_quantize_tpu.ops import convert_to_w4a8

    w = (0.1 * rng.standard_normal((64, 128))).astype(np.float32)
    q, s, zp = rtn_quantize(w, QuantType.QInt8, QuantizationStrategy.CHANNEL, -1, True, False)
    qt = make_qtensor(q, s, zp, quant_type=QuantType.QInt8,
                      strategy=QuantizationStrategy.CHANNEL, group_size=-1,
                      symmetric=True, reduce_range=False)
    out = convert_to_w4a8({"s": {"w": qt}})
    assert out["s"]["w"].meta.input_quant.mode == "dynamic"

    # asymmetric 8-bit stays weights-only
    q2, s2, zp2 = rtn_quantize(w, QuantType.QInt8, QuantizationStrategy.CHANNEL, -1, False, False)
    qt2 = make_qtensor(q2, s2, zp2, quant_type=QuantType.QInt8,
                       strategy=QuantizationStrategy.CHANNEL, group_size=-1,
                       symmetric=False, reduce_range=False)
    out2 = convert_to_w4a8({"s": {"w": qt2}})
    assert out2["s"]["w"].meta.input_quant.mode == "none"

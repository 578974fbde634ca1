import numpy as np
import pytest

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec, make_qtensor
from onnx_quantize_tpu.ops import convert_to_w4a8
from onnx_quantize_tpu.ops.dispatch import select_path
from onnx_quantize_tpu.ops.reference import (
    dequantize_weight,
    dynamic_quantize_params,
    quantized_matmul_jnp,
    static_fake_quant,
)


def _w4a8_qt(rng, K=64, N=128, gs=16, sym=False, qt_type=QuantType.QUInt4):
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    q, s, zp = rtn_quantize(w, qt_type, QuantizationStrategy.GROUP, gs, sym, False)
    return w, make_qtensor(
        q, s, zp, quant_type=qt_type, strategy=QuantizationStrategy.GROUP,
        group_size=gs, symmetric=sym, reduce_range=False, fmt=QFormat.QDQ,
        input_quant=ActQuantSpec(mode="dynamic", dtype="int8", symmetric=True),
    )


@pytest.mark.parametrize("qt_type", [QuantType.QUInt4, QuantType.QInt4])
@pytest.mark.parametrize("K, gs", [(64, 16), (96, 32)])
def test_w4a8_matches_fake_quant_semantics(rng, qt_type, K, gs):
    """The A8 oracle: dynamic int8 symmetric fake-quant of x per tensor, then
    an fp matmul on the dequantized weights."""
    w, qt = _w4a8_qt(rng, K=K, gs=gs, qt_type=qt_type)
    x = rng.standard_normal((6, K)).astype(np.float32)
    y = np.asarray(quantized_matmul_jnp(x, qt))
    scale, zp = dynamic_quantize_params(x, qt.meta.input_quant)
    x_fq = np.asarray(static_fake_quant(x, scale, zp, qt.meta.input_quant))
    assert len(np.unique(x_fq)) <= 255  # x really went through int8
    np.testing.assert_allclose(y, x_fq @ np.asarray(dequantize_weight(qt)),
                               rtol=2e-4, atol=2e-4)
    # and loosely with the fp original (W4 + A8 quantization error)
    np.testing.assert_allclose(y, x @ w, atol=0.35)


@pytest.mark.parametrize("backend, impl, want", [
    ("gpu", "auto", "w4"), ("gpu", "pallas", "w4"), ("cpu", "auto", "jnp"),
])
def test_dispatch_of_a8_sites(rng, backend, impl, want):
    """A W4A8 site takes the W4 kernel on the GPU: the oracle's own prologue
    fake-quantizes x to int8 first, so the kernel serves only the weight
    side. Off the GPU it runs the oracle."""
    _, qt = _w4a8_qt(rng)
    assert select_path((4, 1), qt, backend=backend, impl=impl) == want


def test_w4a8_site_through_the_kernel(rng):
    """The A8 prologue + interpreted kernel equals the A8 oracle."""
    from onnx_quantize_tpu.ops.kernels.matmul_w4 import w4_entry

    _, qt = _w4a8_qt(rng, K=96, gs=32)
    x = rng.standard_normal((5, 96)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(w4_entry(x, qt, None, interpret=True)),
        np.asarray(quantized_matmul_jnp(x, qt)), rtol=1e-4, atol=1e-4,
    )


def test_convert_to_w4a8(rng):
    import jax

    import onnx_quantize_tpu as oqt
    from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config

    model = Gemma3(Gemma3Config.tiny())
    params = model.init(jax.random.key(0))
    qc = oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=32), ignore=["lm_head"]
    )
    qparams, _ = oqt.quantize(model, params, qc)
    a8 = convert_to_w4a8(qparams)
    qt = a8["layers.0"]["attn"]["q_proj"]["w"]
    assert qt.meta.input_quant.mode == "dynamic"
    assert qt.meta.input_quant.dtype == "int8"

    ids = np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    y_w4 = np.asarray(model(qparams, ids))
    y_a8 = np.asarray(model(a8, ids))
    # A8 adds activation quantization error but stays close.
    assert np.all(np.isfinite(y_a8))
    rel = np.mean(np.abs(y_a8 - y_w4)) / np.mean(np.abs(y_w4))
    assert rel < 0.05


def test_convert_skips_hqq_float_zp(rng):
    from onnx_quantize_tpu.algorithms.hqq import hqq_quantize

    w = (0.1 * rng.standard_normal((64, 32))).astype(np.float32)
    q, s, zp = hqq_quantize(w, QuantType.QUInt4, 16)
    qt = make_qtensor(
        q, s, zp, quant_type=QuantType.QUInt4, strategy=QuantizationStrategy.GROUP,
        group_size=16, symmetric=False, reduce_range=False,
    )
    out = convert_to_w4a8({"site": {"w": qt}})
    assert out["site"]["w"].meta.input_quant.mode == "none"

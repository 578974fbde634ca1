import numpy as np
import pytest

import jax
import jax.numpy as jnp

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy
from onnx_quantize_tpu.nn.qtensor import make_qtensor
from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp
from onnx_quantize_tpu.parallel import make_mesh
from onnx_quantize_tpu.parallel.tp_ops import (
    column_parallel_matmul,
    row_parallel_matmul,
    tp_pair_matmul,
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(model_parallel=4)


def _qt(rng, K, N, qt_type=QuantType.QUInt4, gs=16):
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    strategy = QuantizationStrategy.GROUP if gs > 0 else QuantizationStrategy.CHANNEL
    q, s, zp = rtn_quantize(w, qt_type, strategy, gs, False, False)
    return make_qtensor(
        q, s, zp, quant_type=qt_type, strategy=strategy, group_size=gs,
        symmetric=False, reduce_range=False,
    )


def test_column_parallel_matches_single_device(rng, mesh):
    qt = _qt(rng, K=64, N=256, gs=16)
    x = jnp.asarray(rng.standard_normal((8, 64)).astype(np.float32))
    y_tp = np.asarray(column_parallel_matmul(x, qt, mesh))
    y_ref = np.asarray(quantized_matmul_jnp(x, qt))
    np.testing.assert_allclose(y_tp, y_ref, atol=1e-5)


def test_column_parallel_with_bias(rng, mesh):
    qt = _qt(rng, K=64, N=256, gs=16)
    bias = rng.standard_normal(256).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((8, 64)).astype(np.float32))
    y_tp = np.asarray(column_parallel_matmul(x, qt, mesh, bias=jnp.asarray(bias)))
    y_ref = np.asarray(quantized_matmul_jnp(x, qt)) + bias
    np.testing.assert_allclose(y_tp, y_ref, atol=1e-5)


def test_row_parallel_matches_single_device(rng, mesh):
    # K=128 over 4 shards -> 32 rows/shard; gs=16 divides, 2 groups/shard (even).
    qt = _qt(rng, K=128, N=128, gs=16)
    x_full = jnp.asarray(rng.standard_normal((8, 128)).astype(np.float32))
    y_tp = np.asarray(row_parallel_matmul(x_full, qt, mesh))
    y_ref = np.asarray(quantized_matmul_jnp(x_full, qt))
    np.testing.assert_allclose(y_tp, y_ref, atol=1e-4)


def test_column_parallel_with_pallas_kernels(rng, mesh):
    """The W4 kernel (Pallas interpreter, asked for explicitly on the CPU)
    must compose with shard_map: per-device local shapes hit the kernel,
    collectives stay outside."""
    from onnx_quantize_tpu import ops

    qt = _qt(rng, K=64, N=512, gs=16)  # 512/4 = 128 per shard: kernel-tileable
    x = jnp.asarray(rng.standard_normal((8, 64)).astype(np.float32))
    ops.set_impl("pallas", interpret=True)
    try:
        y_tp = np.asarray(column_parallel_matmul(x, qt, mesh))
    finally:
        ops.set_impl("auto")
    y_ref = np.asarray(quantized_matmul_jnp(x, qt))
    np.testing.assert_allclose(y_tp, y_ref, atol=1e-5)


def test_tp_pair_single_psum_matches(rng, mesh):
    """column(up) -> gelu -> row(down) with one psum == single-device chain."""
    qt_up = _qt(rng, K=64, N=256, gs=16)
    qt_down = _qt(rng, K=256, N=64, gs=16)
    x = jnp.asarray(rng.standard_normal((8, 64)).astype(np.float32))
    y_tp = np.asarray(
        tp_pair_matmul(x, qt_up, qt_down, mesh, activation=jax.nn.gelu)
    )
    h = quantized_matmul_jnp(x, qt_up)
    y_ref = np.asarray(quantized_matmul_jnp(jax.nn.gelu(h), qt_down))
    np.testing.assert_allclose(y_tp, y_ref, atol=1e-4)

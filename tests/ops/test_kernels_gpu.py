"""The W4 kernel compiled for the GPU (no interpreter) vs the jnp oracle.

Marked ``gpu``: skipped where JAX finds no GPU; ``chip_smoke.py`` runs these
on the card. Tolerances as in ``test_kernels.py``; the f32 oracle runs at the
highest matmul precision (a float32 matmul on the GPU otherwise runs in TF32).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy
from onnx_quantize_tpu.engine import prepare_kernel_scales
from onnx_quantize_tpu.nn.qtensor import make_qtensor
from onnx_quantize_tpu.ops.kernels.matmul_w4 import w4_dequant_matmul
from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp

pytestmark = pytest.mark.gpu


def _qt(rng, K, N, qt_type, strategy, gs):
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    q, s, zp = rtn_quantize(w, qt_type, strategy, gs, False, False)
    return prepare_kernel_scales(make_qtensor(
        q, s, zp, quant_type=qt_type, strategy=strategy, group_size=gs,
        symmetric=False, reduce_range=False,
    ))


def _err(y, ref):
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("M", [1, 33])
@pytest.mark.parametrize("qt_type", [QuantType.QUInt4, QuantType.QInt4])
def test_compiled_kernel_matches_oracle(gpu, rng, qt_type, M):
    qt = _qt(rng, 1152, 1536, qt_type, QuantizationStrategy.GROUP, 128)
    x = jnp.asarray(rng.standard_normal((M, 1152)), jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = quantized_matmul_jnp(x, qt)
    assert _err(w4_dequant_matmul(x, qt), ref) <= 1e-4
    xb = x.astype(jnp.bfloat16)
    assert _err(w4_dequant_matmul(xb, qt), quantized_matmul_jnp(xb, qt)) <= 1e-2


def test_compiled_kernel_channel(gpu, rng):
    qt = _qt(rng, 640, 256, QuantType.QUInt4, QuantizationStrategy.CHANNEL, -1)
    x = jnp.asarray(rng.standard_normal((8, 640)), jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = quantized_matmul_jnp(x, qt)
    assert _err(w4_dequant_matmul(x, qt), ref) <= 1e-4

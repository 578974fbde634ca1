"""Round-to-nearest weight quantization (default algorithm).

Parity with the reference RTN layer
(``/root/reference/src/onnx_quantize/core/_algorithms/rtn.py:27-138``): layout
preprocess -> qparams -> quantize -> layout postprocess, with scale/zp squeezed
for tensor/channel strategies and kept ``(rows, 1)`` for group strategy; plus the
int32 bias quantizer with ``bias_scale = w_scale * x_scale`` and zp = 0.

The math runs through the jnp numerics core, so it executes on the accelerator when weights
are device-resident and on CPU otherwise.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Literal

import jax.numpy as jnp
import numpy as np

from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy
from onnx_quantize_tpu.core.numerics import (
    compute_qparams_from_array,
    postprocess_array,
    preprocess_array,
    quantize_from_qparams,
)
from onnx_quantize_tpu.core.qconfig import AlgorithmConfig, register_algorithm_config

if TYPE_CHECKING:
    from onnx_quantize_tpu.core.qconfig import QConfig
    from onnx_quantize_tpu.plan import PlanEntry

__all__ = ["RTNConfig", "rtn_quantize", "quantize_bias"]


@register_algorithm_config
class RTNConfig(AlgorithmConfig):
    """Round-to-nearest: no extra parameters beyond QWeightArgs."""

    algorithm_type: Literal["rtn"] = "rtn"

    def quantize_weights(
        self,
        weight: np.ndarray,
        qconfig: "QConfig",
        entry: "PlanEntry | None" = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        w = qconfig.weights
        group_size = entry.group_size if entry is not None else w.group_size
        return rtn_quantize(
            weight,
            w.dtype,
            strategy=w.strategy,
            group_size=group_size if group_size is not None else -1,
            is_symmetric=w.symmetric,
            reduce_range=w.reduce_range,
            clip_ratio=w.clip_ratio,
            mse=w.mse,
            scale_dtype=w.scale_dtype,
            zp_dtype=w.zp_dtype,
        )


def rtn_quantize(
    array,
    quant_type: QuantType,
    strategy: QuantizationStrategy,
    group_size: int,
    is_symmetric: bool,
    reduce_range: bool,
    clip_ratio: float = 1.0,
    mse: bool = False,
    scale_dtype=np.float32,
    zp_dtype=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize a ``(in_features, out_features)`` weight round-to-nearest.

    Returns ``(q_weight, scale, zero_point)`` as numpy arrays; ``q_weight`` has
    the original layout in the quantized container dtype; scale/zp are scalars
    (tensor), ``(out,)`` vectors (channel), or ``(out * n_groups, 1)`` (group).
    """
    array = jnp.asarray(array, dtype=jnp.float32)
    pre = preprocess_array(array, strategy, group_size)
    scale, zp = compute_qparams_from_array(
        pre,
        quant_type,
        strategy,
        group_size,
        is_symmetric,
        reduce_range,
        clip_ratio=clip_ratio,
        mse=mse,
        scale_dtype=scale_dtype,
        zp_dtype=zp_dtype,
    )
    q = quantize_from_qparams(pre, scale, zp, quant_type, is_symmetric, reduce_range)

    # Squeeze scale/zp for tensor/channel (group keeps its (rows, 1) shape),
    # matching the artifact layout the reference emits (rtn.py:101-104).
    if strategy in {QuantizationStrategy.TENSOR, QuantizationStrategy.CHANNEL}:
        scale, zp = jnp.squeeze(scale), jnp.squeeze(zp)

    q = postprocess_array(q, array.shape, strategy, group_size)
    return np.asarray(q), np.asarray(scale), np.asarray(zp)


def quantize_bias(bias, input_scale, weight_scale):
    """Quantize a bias vector to int32 with ``bias_scale = w_scale * x_scale``.

    Mirrors ``rtn.py:112-138``: zp = 0, int32 asymmetric full range.
    """
    bias = np.asarray(bias)
    assert bias.ndim == 1
    assert bias.dtype == np.float32
    input_scale = np.asarray(input_scale)
    weight_scale = np.asarray(weight_scale)
    assert input_scale.size == 1
    assert weight_scale.dtype == np.float32
    assert weight_scale.size == 1 or bias.size == weight_scale.size

    bias_scale = weight_scale * input_scale
    qbias = quantize_from_qparams(
        bias,
        scale=bias_scale,
        zero_point=0,
        quant_type=QuantType.QInt32,
        is_symmetric=False,
        reduce_range=False,
    )
    return np.asarray(qbias), bias_scale, 0

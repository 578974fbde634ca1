"""Qparam math core (pure jnp — runs on any JAX backend identically).

JAX re-implementation of the reference numerics layer
(``/root/reference/src/onnx_quantize/core/_algorithms/utils.py:6-348``), keeping
its exact numeric rules so quantized artifacts match at the bit level:

  * layout preprocessing: CHANNEL -> transpose, GROUP -> ``(in,out)`` ->
    ``(out*n_groups, group_size)`` reshape (``utils.py:6-39``),
  * min/max with clip_ratio applied *before* the force-zero-in-range clamp
    (``utils.py:42-69``),
  * quantize = ``clip(round(x/s) + zp, qmin, qmax)`` with round-half-even
    (``utils.py:72-79``),
  * asymmetric scale/zp: ``s=(rmax-rmin)/(qmax-qmin)``, degenerate s -> 1,
    ``zp=round(clip(qmin - rmin/s, qmin, qmax))`` — clip *before* round
    (``utils.py:258-271``),
  * symmetric: mid-range zero point and min(pos,neg) usable levels so unsigned
    symmetric works (zp=128 for uint8) (``utils.py:273-294``),
  * MSE range search: shrink grid p=1-i/grid for ``maxshrink*grid`` steps,
    Lp-norm error (norm=2.4), early-stop patience 5 (``utils.py:140-239``).

All functions accept numpy or jax arrays and compute in float32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy

__all__ = [
    "preprocess_array",
    "postprocess_array",
    "compute_min_max",
    "quantize_from_qparams",
    "fake_quantize",
    "dequantize",
    "compute_min_max_mse",
    "compute_qparams",
    "compute_qparams_from_array",
]

_F32_TINY = float(np.finfo(np.float32).tiny)
_F32_MAX = float(np.finfo(np.float32).max)


def _resolved_group_size(in_channels: int, group_size: int) -> int:
    if group_size == -1 or group_size is None:
        return in_channels
    return min(group_size, in_channels)


def preprocess_array(array, strategy: QuantizationStrategy, group_size: int = -1):
    """Reshape a weight ``(in, out)`` into rows sharing one scale/zp.

    TENSOR: unchanged. CHANNEL: ``(out, in)``. GROUP: ``(out * n_groups,
    group_size)`` — row-major over the transposed weight, so group ``g`` of
    out-channel ``j`` is row ``j * n_groups + g`` (ref ``utils.py:6-27``).
    """
    array = jnp.asarray(array)
    if strategy == QuantizationStrategy.TENSOR:
        return array
    if strategy == QuantizationStrategy.CHANNEL:
        return array.T
    if strategy == QuantizationStrategy.GROUP:
        gs = _resolved_group_size(array.shape[0], group_size)
        return array.T.reshape((-1, gs))
    raise ValueError(f"Unknown strategy {strategy}")


def postprocess_array(preprocessed, original_shape, strategy, group_size: int = -1):
    """Inverse of :func:`preprocess_array` back to ``original_shape``."""
    preprocessed = jnp.asarray(preprocessed)
    if strategy == QuantizationStrategy.TENSOR:
        return preprocessed
    if strategy == QuantizationStrategy.CHANNEL:
        return preprocessed.T
    if strategy == QuantizationStrategy.GROUP:
        in_ch, out_ch = original_shape
        return preprocessed.reshape((out_ch, in_ch)).T
    raise ValueError(f"Unknown strategy {strategy}")


def compute_min_max(array, strategy, group_size: int = -1, clip_ratio: float = 1.0):
    """Per-row (or global) min/max with clip ratio and zero-in-range clamp."""
    array = jnp.asarray(array)
    if strategy == QuantizationStrategy.TENSOR:
        axis, keep = None, False
    else:
        axis, keep = 1, True

    min_val = jnp.min(array, axis=axis, keepdims=keep) * clip_ratio
    max_val = jnp.max(array, axis=axis, keepdims=keep) * clip_ratio
    # Include zero in the range so the zero point is exactly representable.
    min_val = jnp.minimum(min_val, 0)
    max_val = jnp.maximum(max_val, 0)
    return min_val, max_val


def quantize_from_qparams(array, scale, zero_point, quant_type: QuantType,
                          is_symmetric: bool, reduce_range: bool):
    """``clip(round(x / s) + zp, qmin, qmax)`` in the quantized container dtype."""
    array = jnp.asarray(array, dtype=jnp.float32)
    scaled = array / jnp.asarray(scale, dtype=jnp.float32)
    shifted = jnp.round(scaled).astype(jnp.int32) + jnp.asarray(zero_point)
    qmin, qmax = quant_type.qrange(is_symmetric, reduce_range)
    q = jnp.clip(shifted, qmin, qmax)
    return q.astype(jnp.dtype(quant_type.container_dtype))


def dequantize(q_array, scale, zero_point, *, preprocess: bool = False,
               strategy: QuantizationStrategy | None = None, group_size: int = -1):
    """``(q - zp) * s`` with optional layout preprocessing (ref ``utils.py:102-137``)."""
    q_array = jnp.asarray(q_array)
    scale = jnp.asarray(scale, dtype=jnp.float32)
    zero_point = jnp.asarray(zero_point)
    pre = q_array
    if preprocess:
        assert strategy is not None, "strategy must be provided if preprocess is True"
        pre = preprocess_array(q_array, strategy, group_size)
        if strategy == QuantizationStrategy.CHANNEL:
            scale = jnp.expand_dims(scale, axis=1)
            zero_point = jnp.expand_dims(zero_point, axis=1)
    dq = (pre.astype(jnp.float32) - zero_point.astype(jnp.float32)) * scale
    if preprocess:
        dq = postprocess_array(dq, q_array.shape, strategy, group_size)
    return dq


def fake_quantize(array, scale, zero_point, quant_type, is_symmetric, reduce_range):
    q = quantize_from_qparams(array, scale, zero_point, quant_type, is_symmetric, reduce_range)
    return dequantize(q, scale, zero_point)


def compute_qparams(rmin, rmax, quant_type: QuantType, is_symmetric: bool,
                    reduce_range: bool, scale_dtype=np.float32, zp_dtype=None):
    """Scale/zero-point from a range. Exact reference rules (``utils.py:242-299``)."""
    rmin = jnp.asarray(rmin, dtype=jnp.float32)
    rmax = jnp.asarray(rmax, dtype=jnp.float32)
    if zp_dtype is None:
        zp_dtype = quant_type.container_dtype

    if is_symmetric:
        rabs = jnp.maximum(jnp.abs(rmin), jnp.abs(rmax))
        qmin, qmax = quant_type.qrange(is_symmetric=True, reduce_range=reduce_range)
        zero = round((qmax + qmin) / 2.0)
        # The two sides of the fixed zero point may have different level counts
        # (uint8 symmetric: zp=128, 127 positive vs 128 negative levels); use the
        # smaller side so quantization cannot overflow.
        max_levels = min(qmax - zero, zero - qmin)
        scale = rabs / max_levels
        scale = jnp.where(scale < _F32_TINY, 1.0, scale)
        zp = jnp.full(rabs.shape, zero)
        return scale.astype(jnp.dtype(scale_dtype)), zp.astype(jnp.dtype(zp_dtype))

    qmin, qmax = quant_type.qrange(is_symmetric=False, reduce_range=reduce_range)
    scale = (rmax - rmin) / (qmax - qmin)
    scale = jnp.where(scale < _F32_TINY, 1.0, scale)
    zp = qmin - (rmin / scale)
    zp = jnp.round(jnp.clip(zp, qmin, qmax))
    return scale.astype(jnp.dtype(scale_dtype)), zp.astype(jnp.dtype(zp_dtype))


@functools.partial(
    jax.jit,
    static_argnames=("quant_type", "strategy", "is_symmetric", "reduce_range", "axis"),
)
def _mse_candidate_error(array, rmin, rmax, p, quant_type, strategy,
                         is_symmetric, reduce_range, axis, norm):
    """Error of one shrink candidate ``p`` — jitted, shapes static per weight."""
    shrunk_min = p * rmin
    shrunk_max = p * rmax
    scale, zp = compute_qparams(
        shrunk_min, shrunk_max, quant_type, is_symmetric, reduce_range,
        scale_dtype=np.float32, zp_dtype=np.float32,
    )
    q = fake_quantize(array, scale, zp, quant_type, is_symmetric, reduce_range)
    err = jnp.power(jnp.abs(q - array), norm)
    keep = axis is not None
    return jnp.sum(err, axis=axis, keepdims=keep)


def compute_min_max_mse(array, quant_type, strategy, group_size, is_symmetric,
                        reduce_range, scale_dtype=np.float32, zp_dtype=None,
                        maxshrink: float = 0.20, patience: int = 5,
                        grid: float = 100.0, norm: float = 2.4):
    """MSE-optimal range search over a shrink grid.

    Candidate errors are computed fully vectorized on device (one jitted
    fake-quant per grid point); the best-per-row tracking and the
    no-improvement early stop (patience 5) run on host, preserving the exact
    reference semantics (``utils.py:140-239``).
    """
    array = jnp.asarray(array, dtype=jnp.float32)
    axis = None if strategy == QuantizationStrategy.TENSOR else 1
    rmin, rmax = compute_min_max(array, strategy, group_size, clip_ratio=1.0)

    best_error = np.full(np.shape(rmin), _F32_MAX, dtype=np.float32)
    best_min = np.asarray(rmin).copy()
    best_max = np.asarray(rmax).copy()

    no_improve = 0
    for i in range(int(maxshrink * grid)):
        p = 1.0 - i / grid
        err = np.asarray(
            _mse_candidate_error(
                array, rmin, rmax, jnp.float32(p), quant_type, strategy,
                is_symmetric, reduce_range, axis, jnp.float32(norm),
            )
        )
        improved = err < best_error
        if improved.any():
            best_error = np.where(improved, err, best_error)
            best_min = np.where(improved, p * np.asarray(rmin), best_min)
            best_max = np.where(improved, p * np.asarray(rmax), best_max)
        else:
            # The reference counts non-improving iterations CUMULATIVELY —
            # the counter is never reset on improvement (utils.py:225-239).
            no_improve += 1
        if no_improve >= patience:
            break

    return jnp.asarray(best_min), jnp.asarray(best_max)


def compute_qparams_from_array(array, quant_type, strategy, group_size,
                               is_symmetric, reduce_range, clip_ratio: float = 1.0,
                               mse: bool = False, scale_dtype=np.float32,
                               zp_dtype=None):
    """Qparams straight from a (already layout-preprocessed) tensor."""
    rmin, rmax = compute_min_max(array, strategy, group_size, clip_ratio)
    if mse:
        rmin, rmax = compute_min_max_mse(
            array, quant_type, strategy, group_size, is_symmetric, reduce_range,
            scale_dtype, zp_dtype,
        )
    return compute_qparams(
        rmin, rmax, quant_type, is_symmetric, reduce_range, scale_dtype, zp_dtype
    )

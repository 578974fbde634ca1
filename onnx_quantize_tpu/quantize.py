"""quantize(): the main entry point.

JAX analogue of the reference's ``src/onnx_quantize/quantize.py:28-80``:

    model (Module) + params (pytree) + QConfig
      -> untie shared weights            (≙ DuplicateInitializersPass)
      -> build QuantPlan over sites      (≙ get_target_nodes + qrule matching)
      -> calibrate / stamp / pre-passes  (≙ apply_pre_passes)
      -> per-site weight transform       (≙ rewriter + qfunctions)
      -> quantized params + plan         (≙ quantized ONNX artifact)

The reference's onnxscript optimizer / opset conversion steps collapse: XLA is
the op fuser, and module sites are already in canonical (transB=0) layout.
"""

from __future__ import annotations

import numpy as np

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.algorithms.rtn import quantize_bias, rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.core.qconfig import QConfig
from onnx_quantize_tpu.nn.module import Module
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec, QBias, make_qtensor
from onnx_quantize_tpu.plan import PlanEntry, QuantPlan, build_plan
from onnx_quantize_tpu.prepasses import apply_pre_passes
from onnx_quantize_tpu.utils import tree_get, untie_params

logger = get_logger(__name__)

__all__ = ["quantize", "is_nbits_kernel_compatible"]


def _no_quantization_needed(qconfig: QConfig) -> bool:
    return (
        qconfig.weights is None
        and qconfig.input_activations is None
        and qconfig.output_activations is None
    )


def is_nbits_kernel_compatible(qconfig: QConfig, name: str = "") -> bool:
    """Grouped weights-only configs eligible for the fused nbits kernel.

    Mirrors ``qrules/_common.py:32-62`` (the MatMulNBits gate): weights-only,
    uint4/uint8, group strategy, group_size a power of two >= 16.
    """
    weights_only = qconfig.input_activations is None and qconfig.output_activations is None
    log_msg = f"Found incompatibility for the nbits kernel in {name}: "

    if not weights_only:
        logger.debug(log_msg + "It only supports weight-only quantization.")
        return False
    if qconfig.weights.dtype not in {QuantType.QUInt4, QuantType.QUInt8}:
        logger.debug(
            log_msg + f"It only supports uint4 and uint8 weight types. "
            f"Found: {qconfig.weights.dtype}"
        )
        return False
    if qconfig.weights.strategy != QuantizationStrategy.GROUP:
        logger.debug(
            log_msg + f"It only supports 'group' quantization strategy. "
            f"Found: {qconfig.weights.strategy}"
        )
        return False
    group_size = qconfig.weights.group_size
    if group_size != -1 and (group_size < 16 or (group_size & (group_size - 1)) != 0):
        logger.debug(log_msg + "group_size should be a power of 2 greater than or equal to 16.")
        return False
    return True


def _act_spec(qargs) -> ActQuantSpec:
    if qargs is None:
        return ActQuantSpec(mode="none")
    return ActQuantSpec(
        mode="static" if qargs.is_static else "dynamic",
        dtype=qargs.dtype.value,
        symmetric=qargs.symmetric,
        reduce_range=qargs.reduce_range,
    )


def _quantize_bias_qdq(bias: np.ndarray, qcfg: QConfig) -> QBias:
    """QDQ Gemm bias: RTN per-tensor in the weight dtype (``gemm_to_qgemm.py``)."""
    w = qcfg.weights
    b_q, b_scale, b_zp = rtn_quantize(
        bias.reshape(-1, 1),
        quant_type=w.dtype,
        strategy=QuantizationStrategy.TENSOR,
        group_size=-1,
        is_symmetric=w.symmetric,
        reduce_range=w.reduce_range,
        clip_ratio=w.clip_ratio,
        mse=w.mse,
        scale_dtype=w.scale_dtype,
        zp_dtype=w.zp_dtype,
    )
    return QBias(
        data=b_q.reshape(-1), scale=b_scale, zero_point=b_zp, quant_type=w.dtype.value
    )


def _transform_site(entry: PlanEntry, params: dict) -> None:
    from onnx_quantize_tpu.nn.qtensor import QTensor

    qcfg = entry.qconfig()
    if qcfg.weights is None:
        return

    site_params = tree_get(params, entry.site.param_path)
    if isinstance(site_params["w"], QTensor):
        # Already quantized by a previous pass (mixed per-site configs are
        # applied as sequential quantize() calls with complementary ignore
        # patterns); leave it as-is.
        logger.info("Site %s already quantized; skipping.", entry.name)
        return
    weight = np.asarray(site_params["w"], dtype=np.float32)

    q, scale, zp = qcfg.weights.algorithm.quantize_weights(weight, qcfg, entry)

    in_spec = _act_spec(qcfg.input_activations)
    out_spec = _act_spec(qcfg.output_activations)

    if in_spec.mode == "static" and entry.input_scale is None:
        raise RuntimeError(
            f"Static input activation quantization requested for {entry.name} "
            "but no calibrated input scale is present."
        )
    if out_spec.mode == "static" and entry.output_scale is None:
        raise RuntimeError(
            f"Static output activation quantization requested for {entry.name} "
            "but no calibrated output scale is present."
        )

    gs = entry.group_size if entry.group_size is not None else -1
    qt = make_qtensor(
        q, scale, zp,
        quant_type=qcfg.weights.dtype,
        strategy=qcfg.weights.strategy,
        group_size=gs,
        symmetric=qcfg.weights.symmetric,
        reduce_range=qcfg.weights.reduce_range,
        fmt=qcfg.format if isinstance(qcfg.format, QFormat) else QFormat(qcfg.format),
        input_quant=in_spec,
        output_quant=out_spec,
        input_scale=entry.input_scale,
        input_zero_point=entry.input_zero_point,
        output_scale=entry.output_scale,
        output_zero_point=entry.output_zero_point,
    )
    site_params["w"] = qt

    bias = site_params.get("b")
    if bias is not None and entry.site.op_type == "Gemm":
        bias = np.asarray(bias, dtype=np.float32)
        if qt.meta.fmt == QFormat.QLINEAR:
            # int32 bias with scale = x_scale * w_scale, zp = 0 (ref rtn.py:112-138).
            b_q, b_scale, _ = quantize_bias(
                bias, np.asarray(entry.input_scale), np.asarray(scale, dtype=np.float32)
            )
            site_params["b"] = QBias(
                data=b_q, scale=b_scale, zero_point=np.int32(0),
                quant_type=QuantType.QInt32.value,
            )
        elif not is_nbits_kernel_compatible(qcfg, entry.name):
            # QDQ bias quantized per-tensor in the weight dtype; the fused
            # nbits path keeps the fp bias (MatMulNBits semantics).
            site_params["b"] = _quantize_bias_qdq(bias, qcfg)

    # The raw captured activations can be large; free them once consumed.
    entry.captured_input = None


def quantize(model: Module, params, qconfig: QConfig):
    """Quantize ``params`` of ``model`` per ``qconfig``.

    Returns ``(quantized_params, plan)``. The input params tree is not
    mutated; quantized sites carry :class:`QTensor` weights (and
    :class:`QBias` biases where the format requires).
    """
    if not isinstance(qconfig, QConfig):
        raise TypeError(f"qconfig must be a QConfig, got {type(qconfig)}")
    if not isinstance(model, Module):
        raise TypeError(f"model must be a Module, got {type(model)}")

    if _no_quantization_needed(qconfig):
        logger.info("No quantization parameters provided; returning params unchanged.")
        return params, QuantPlan()

    logger.info("Starting quantization")
    model.finalize()
    sites = model.linear_sites()
    plan = build_plan(sites, qconfig)
    params = untie_params(params, [e.site.param_path for e in plan])

    # Work on a re-validated copy so mutation (e.g. clearing calibration_data)
    # does not leak into the caller's config.
    qconfig = qconfig.model_copy(deep=False)

    apply_pre_passes(model, params, plan, qconfig)

    logger.info("Applying quantization transforms to %d sites", len(plan))
    for entry in plan:
        _transform_site(entry, params)

    logger.info("Quantization finished")
    return params, plan

"""onnx_quantize_tpu — a JAX post-training-quantization framework.

Brand-new JAX/XLA/Pallas implementation with the capabilities of the reference
``onnx_quantize`` library (see SURVEY.md): QConfig-driven weight-only / dynamic /
static quantization (int4/uint4/int8/uint8; symmetric/asymmetric;
per-tensor/per-channel/group), RTN/GPTQ/HQQ algorithms, SmoothQuant/AWQ
pre-passes, jit'd calibration with activation taps, and quantized execution via
a fused W4 dequant-matmul decode kernel (Pallas, Triton route) on the GPU —
plus the serving pieces the reference outsources to ONNX Runtime: an inference engine with an int8 KV-cache
and mesh-sharded multi-device execution.
"""

from onnx_quantize_tpu import _logging  # noqa: F401  (configures package logger)
from onnx_quantize_tpu._logging import set_log_level
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.core.qconfig import (
    Backend,
    CalibrationParams,
    QActivationArgs,
    QConfig,
    QWeightArgs,
)

# Algorithm / preprocessor configs register themselves on import.
from onnx_quantize_tpu.algorithms.rtn import RTNConfig
from onnx_quantize_tpu.algorithms.gptq import GPTQConfig
from onnx_quantize_tpu.algorithms.hqq import HqqConfig
from onnx_quantize_tpu.prepasses.smooth_quant import SmoothQuantConfig
from onnx_quantize_tpu.prepasses.awq import AwqConfig
from onnx_quantize_tpu.prepasses.rotate import RotateConfig

from onnx_quantize_tpu.quantize import quantize

__all__ = [
    "quantize",
    "QConfig",
    "QuantType",
    "QWeightArgs",
    "QActivationArgs",
    "QFormat",
    "QuantizationStrategy",
    "RTNConfig",
    "GPTQConfig",
    "HqqConfig",
    "AwqConfig",
    "RotateConfig",
    "SmoothQuantConfig",
    "CalibrationParams",
    "Backend",
    "set_log_level",
]

__version__ = "0.1.0"

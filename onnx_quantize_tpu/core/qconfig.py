"""Declarative quantization configuration.

Capability-parity re-implementation of the reference config system
(``/root/reference/src/onnx_quantize/core/_qconfig.py:46-502``): the same public
surface (``QConfig``, ``QWeightArgs``, ``QActivationArgs``, plugin registries)
and the same cross-field validation rules, adapted to this JAX build:

  * ``target_op_types`` still accepts {"MatMul", "Gemm"}; in the module world a
    ``Linear`` without bias is a MatMul site, with bias a Gemm site.
  * calibration executes as jit'd JAX forwards with activation taps, so
    ``CalibrationParams.backend`` replaces the ORT ExecutionProvider enum
    (``_calibration/base.py:12-32``) with JAX platforms (cpu/gpu, or JAX's default).
  * configs round-trip through the serialized :class:`~onnx_quantize_tpu.plan.QuantPlan`
    (the analogue of ``node.meta["qconfig"]``), which is why algorithm and
    preprocessor configs dispatch through tag registries.
"""

from __future__ import annotations

import enum
from collections.abc import Sequence
from typing import TYPE_CHECKING, Any, ClassVar

import numpy as np
from pydantic import (
    BaseModel,
    ConfigDict,
    Field,
    SerializeAsAny,
    field_validator,
    model_validator,
)

from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy

if TYPE_CHECKING:
    from onnx_quantize_tpu.plan import PlanEntry

__all__ = [
    "QConfig",
    "QWeightArgs",
    "QActivationArgs",
    "QuantizationStrategy",
    "QFormat",
    "AlgorithmConfig",
    "PreProcessingConfig",
    "CalibrationParams",
    "CalibrationMethod",
    "Backend",
    "register_algorithm_config",
    "register_preprocessing_config",
]

_SUPPORTED_OP_TYPES = ("MatMul", "Gemm")


class Backend(str, enum.Enum):
    """JAX platform used to run calibration forwards (our ExecutionProvider).

    ``DEFAULT`` resolves to ``jax.default_backend()`` when calibration runs."""

    CPU = "cpu"
    GPU = "gpu"
    DEFAULT = "default"

    @classmethod
    def from_alias(cls, value: str) -> "Backend":
        aliases = {"cpu": cls.CPU, "gpu": cls.GPU, "default": cls.DEFAULT}
        key = value.lower()
        if key in aliases:
            return aliases[key]
        try:
            return cls(value)
        except ValueError:
            valid = sorted({*aliases, *(b.value for b in cls)})
            raise ValueError(  # noqa: B904
                f"Invalid backend '{value}'. Valid values are: {valid}"
            )


class CalibrationMethod(enum.Enum):
    MINMAX = "minmax"
    PERCENTILE = "percentile"
    ENTROPY = "entropy"


class CalibrationParams(BaseModel):
    """Calibration knobs (ref ``_calibration/base.py:41-97``).

    num_samples / batch_size control the calibration mini-batching; momentum
    enables EMA smoothing in the MinMax calibrator; backend picks the JAX
    platform the calibration forward runs on.
    """

    model_config = ConfigDict(extra="forbid")

    method: CalibrationMethod | str = CalibrationMethod.MINMAX
    num_samples: int = 100
    batch_size: int = 10
    momentum: float = 0.0
    percentile: float = 0.999  # used by method="percentile"
    backend: Backend | str = Field(default=Backend.CPU)

    @field_validator("method", mode="before")
    def _validate_method(cls, value):
        if isinstance(value, str):
            try:
                return CalibrationMethod(value)
            except ValueError:
                valid = [m.value for m in CalibrationMethod]
                raise ValueError(  # noqa: B904
                    f"Invalid calibration method '{value}'. Valid methods are: {valid}"
                )
        return value

    @field_validator("backend", mode="before")
    def _validate_backend(cls, value):
        if isinstance(value, str):
            return Backend.from_alias(value)
        return value

    @field_validator("momentum", mode="after")
    def _validate_momentum(cls, value):
        if not 0 <= value < 1:
            raise ValueError(f"Momentum must be in [0, 1), got {value}")
        return value

    @field_validator("percentile", mode="after")
    def _validate_percentile(cls, value):
        if not 0 < value <= 1:
            raise ValueError(f"percentile must be in (0, 1], got {value}")
        return value

    @field_validator("num_samples", "batch_size", mode="after")
    def _validate_positive(cls, value, info):
        if value <= 0:
            raise ValueError(f"{info.field_name} must be positive, got {value}")
        return value


class AlgorithmConfig(BaseModel):
    """Base class for weight-quantization algorithms.

    Subclasses declare an ``algorithm_type`` Literal tag, register via
    :func:`register_algorithm_config`, and implement :meth:`quantize_weights`
    returning ``(q_weight, scale, zero_point)`` numpy arrays for a weight laid
    out ``(in_features, out_features)``.
    """

    # Whether the algorithm needs input activations collected during calibration.
    requires_calibration: ClassVar[bool] = False

    def validate_weight_args(self, weight_args: "QWeightArgs") -> None:
        """Hook for algorithm-specific constraints on the enclosing QWeightArgs."""

    def quantize_weights(
        self,
        weight: np.ndarray,
        qconfig: "QConfig",
        entry: "PlanEntry | None" = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError(
            f"{type(self).__name__} must implement quantize_weights()."
        )


class PreProcessingConfig(BaseModel):
    """Base class for pre-processing passes (SmoothQuant, AWQ, ...).

    Subclasses declare a ``preprocessing_type`` Literal tag, register via
    :func:`register_preprocessing_config`, and implement :meth:`build_pass`
    returning a callable ``pass_(params, plan, qconfig) -> bool`` that mutates
    the param tree / plan in place (the analogue of an IR InPlacePass).
    """

    requires_calibration: ClassVar[bool] = True
    requires_post_calibration: ClassVar[bool] = True

    def build_pass(self, qconfig: "QConfig"):
        raise NotImplementedError(f"{type(self).__name__} must implement build_pass().")


_ALGORITHM_REGISTRY: dict[str, type[AlgorithmConfig]] = {}
_PREPROCESSING_REGISTRY: dict[str, type[PreProcessingConfig]] = {}


def register_algorithm_config(cls: type[AlgorithmConfig]) -> type[AlgorithmConfig]:
    field = cls.model_fields.get("algorithm_type")
    if field is None:
        raise TypeError(
            f"{cls.__name__} must declare an 'algorithm_type' field to be registered."
        )
    _ALGORITHM_REGISTRY[field.default] = cls
    return cls


def register_preprocessing_config(cls: type[PreProcessingConfig]) -> type[PreProcessingConfig]:
    field = cls.model_fields.get("preprocessing_type")
    if field is None:
        raise TypeError(
            f"{cls.__name__} must declare a 'preprocessing_type' field to be registered."
        )
    _PREPROCESSING_REGISTRY[field.default] = cls
    return cls


def _default_algorithm_config() -> AlgorithmConfig:
    from onnx_quantize_tpu.algorithms.rtn import RTNConfig

    return RTNConfig()


def _resolve_algorithm_config(value):
    if value is None:
        return _default_algorithm_config()
    if isinstance(value, AlgorithmConfig):
        return value
    if isinstance(value, dict):
        tag = value.get("algorithm_type")
        if tag not in _ALGORITHM_REGISTRY:
            raise ValueError(
                f"Unknown algorithm_type {tag!r}. Registered: {sorted(_ALGORITHM_REGISTRY)}"
            )
        return _ALGORITHM_REGISTRY[tag](**value)
    return value


def _resolve_preprocessing_config(value):
    if isinstance(value, PreProcessingConfig):
        return value
    if isinstance(value, dict):
        tag = value.get("preprocessing_type")
        if tag not in _PREPROCESSING_REGISTRY:
            raise ValueError(
                f"Unknown preprocessing_type {tag!r}. "
                f"Registered: {sorted(_PREPROCESSING_REGISTRY)}"
            )
        return _PREPROCESSING_REGISTRY[tag](**value)
    return value


class _BaseArgs(BaseModel):
    model_config = ConfigDict(arbitrary_types_allowed=True)

    dtype: QuantType | str = QuantType.QInt8
    symmetric: bool = False
    group_size: int | None = Field(
        default=None,
        description=">0: group quant, -1: channel quant, None: tensor quant",
    )
    strategy: QuantizationStrategy | str | None = None
    scale_dtype: np.dtype = Field(default=np.dtype(np.float32))
    zp_dtype: np.dtype = Field(default=None, init=False)
    reduce_range: bool = False

    @field_validator("dtype", mode="before")
    def _dtype_before(cls, value):
        if isinstance(value, str):
            return QuantType.from_string(value)
        return value

    @field_validator("group_size", mode="before")
    def _group_before(cls, value):
        if value is None:
            return value
        if value < -1:
            raise ValueError(
                f"Invalid group size {value}. Use group_size > 0 for "
                "strategy='group' and group_size = -1 for 'per_channel'"
            )
        return value

    @field_validator("strategy", mode="before")
    def _strategy_before(cls, value):
        if isinstance(value, str):
            return QuantizationStrategy(value.lower())
        return value

    @field_validator("scale_dtype", mode="before")
    def _scale_dtype_before(cls, value):
        if isinstance(value, type) and issubclass(value, np.generic):
            return np.dtype(value)
        if not isinstance(value, np.dtype):
            return np.dtype(value)
        return value

    @field_validator("scale_dtype", mode="after")
    def _scale_dtype_after(cls, value):
        if value != np.float32:
            raise ValueError("Only float32 scale dtype is currently supported.")
        return value

    @model_validator(mode="after")
    def validate_model_after(self) -> "_BaseArgs":
        strategy = self.strategy
        group_size = self.group_size

        # Infer the strategy from group_size when not given (ref :232-250):
        # None -> tensor, >0 -> group, -1 -> channel.
        if strategy is None:
            if group_size is None:
                strategy = QuantizationStrategy.TENSOR
            elif group_size > 0:
                strategy = QuantizationStrategy.GROUP
            elif group_size == -1:
                strategy = QuantizationStrategy.CHANNEL
            else:
                raise ValueError(
                    f"Invalid group size {group_size}. Use group_size > 0 for "
                    "strategy='group' and group_size = -1 for 'channel'"
                )

        if strategy == QuantizationStrategy.GROUP and (group_size is None or group_size <= 0):
            raise ValueError(
                f"strategy {strategy} requires group_size to be set to a positive value."
            )

        if (
            group_size is not None
            and group_size > 0
            and strategy != QuantizationStrategy.GROUP
        ):
            raise ValueError("group_size requires strategy to be set to 'group'.")

        if self.zp_dtype is None:
            self.zp_dtype = np.dtype(self.dtype.container_dtype)

        self.strategy = strategy
        return self


class QWeightArgs(_BaseArgs):
    """Weight quantization parameters (ref ``_qconfig.py:271-301``)."""

    clip_ratio: float = 1.0
    mse: bool = False
    algorithm: SerializeAsAny[AlgorithmConfig] = Field(
        default_factory=_default_algorithm_config
    )

    @field_validator("algorithm", mode="before")
    def _algorithm_before(cls, value):
        return _resolve_algorithm_config(value)

    @field_validator("clip_ratio", mode="after")
    def _clip_ratio_after(cls, value):
        if not (0.0 < value <= 1.0):
            raise ValueError(f"clip_ratio must be in (0.0, 1.0], got {value}")
        return value

    @model_validator(mode="after")
    def validate_model_after(self) -> "QWeightArgs":
        self.algorithm.validate_weight_args(self)
        return super().validate_model_after()


class QActivationArgs(_BaseArgs):
    """Activation quantization parameters (ref ``_qconfig.py:304-335``)."""

    is_static: bool = True

    @field_validator("strategy", mode="after")
    def _strategy_after(cls, value):
        if value is not None and value != QuantizationStrategy.TENSOR:
            raise NotImplementedError(
                "Activation quantization only supports 'tensor' strategy."
            )
        return QuantizationStrategy.TENSOR

    @field_validator("dtype", mode="after")
    def _dtype_after(cls, value):
        if value in {QuantType.QInt4, QuantType.QUInt4}:
            raise NotImplementedError("4-bit quantization is not supported for activations.")
        return value

    @model_validator(mode="after")
    def validate_model_after(self) -> "QActivationArgs":
        if not self.is_static and self.dtype != QuantType.QUInt8:
            raise NotImplementedError(
                "Dynamic activation quantization only supports uint8 dtype."
            )
        return super().validate_model_after()


class QConfig(BaseModel):
    r"""Top-level quantization spec (ref ``_qconfig.py:338-502``).

    Args:
        target_op_types: which site kinds to quantize; a ``Linear`` with bias is
            a "Gemm" site, without bias a "MatMul" site.
        weights / input_activations / output_activations: per-tensor-class args.
        format: QDQ (fp compute with dequantized weights) or QLINEAR (int8 tensor-core
            compute with requantized outputs).
        calibration_params / calibration_data: calibration configuration. A
            single array maps to the model's first input; a dict maps input
            names to arrays (multi-input models).
        preprocessors: SmoothQuant / AWQ / plugin passes applied before weight
            quantization.
        ignore: regex patterns matched against site names with ``re.search``;
            matching sites are skipped.
    """

    target_op_types: Sequence[str] = Field(default_factory=lambda: _SUPPORTED_OP_TYPES)
    weights: QWeightArgs | None = None
    input_activations: QActivationArgs | None = None
    output_activations: QActivationArgs | None = None
    format: QFormat | str = QFormat.QDQ

    calibration_params: CalibrationParams | None = Field(default_factory=CalibrationParams)
    calibration_data: Any = None
    model_config = ConfigDict(extra="forbid", arbitrary_types_allowed=True)

    preprocessors: Sequence[SerializeAsAny[PreProcessingConfig]] = Field(
        default_factory=tuple
    )
    ignore: Sequence[str] = Field(default_factory=tuple)

    @field_validator("target_op_types", mode="before")
    def _target_op_types_before(cls, value):
        return tuple(sorted(set(value)))

    @field_validator("ignore", mode="before")
    def _ignore_before(cls, value):
        if value is None:
            return ()
        if isinstance(value, str):
            value = (value,)
        return tuple(value)

    @field_validator("preprocessors", mode="before")
    def _preprocessors_before(cls, value):
        if value is None:
            return ()
        return tuple(_resolve_preprocessing_config(item) for item in value)

    @field_validator("format", mode="before")
    def _format_before(cls, value):
        if isinstance(value, str):
            try:
                return QFormat(value.lower())
            except ValueError:
                valid = [f.value for f in QFormat]
                raise ValueError(  # noqa: B904
                    f"Invalid quantization format '{value}'. Valid formats are: {valid}"
                )
        return value

    @field_validator("calibration_params", mode="before")
    def _calibration_params_before(cls, value):
        if isinstance(value, dict):
            return CalibrationParams(**value)
        return value

    def _check_qlinear_format_constraints(self) -> None:
        if self.input_activations is None or self.output_activations is None:
            raise ValueError(
                "QLinear format requires both input and output activation quantization."
            )
        if not (self.input_activations.is_static and self.output_activations.is_static):
            raise ValueError(
                "QLinear format requires both input and output activations "
                "quantization to be static."
            )
        if self.weights.strategy == QuantizationStrategy.GROUP:
            raise NotImplementedError(
                "QLinear format does not support grouped weight quantization."
            )
        valid_dtypes = {QuantType.QInt8, QuantType.QUInt8}
        if self.weights.dtype not in valid_dtypes:
            raise ValueError(
                f"QLinear format supports only int8/uint8 for weights, "
                f"got {self.weights.dtype}."
            )
        if self.input_activations.dtype not in valid_dtypes:
            raise ValueError(
                f"QLinear format supports only int8/uint8 for input activations, "
                f"got {self.input_activations.dtype}."
            )
        if self.output_activations.dtype not in valid_dtypes:
            raise ValueError(
                f"QLinear format supports only int8/uint8 for output activations, "
                f"got {self.output_activations.dtype}."
            )

    @model_validator(mode="after")
    def validate_model_after(self) -> "QConfig":
        for op_type in self.target_op_types:
            if op_type not in _SUPPORTED_OP_TYPES:
                raise ValueError(
                    f"Unsupported operator type '{op_type}' in target_op_types. "
                    f"Supported operator types are: {_SUPPORTED_OP_TYPES}"
                )

        if (
            self.weights is None
            and self.input_activations is None
            and self.output_activations is None
        ):
            return self

        if self.weights is None:
            raise ValueError("Activation only quantization is not supported.")

        weights_only = self.input_activations is None and self.output_activations is None

        if (not weights_only) and self.weights.dtype in {QuantType.QInt4, QuantType.QUInt4}:
            raise NotImplementedError(
                "4-bit quantization is only supported for weights_only quantization."
            )

        if self.weights.strategy == QuantizationStrategy.GROUP and not weights_only:
            raise NotImplementedError(
                "Group quantization is only supported for weights_only quantization."
            )

        if self.input_activations is not None and self.output_activations is not None:
            if self.input_activations.is_static != self.output_activations.is_static:
                raise NotImplementedError(
                    "Both input and output activations must be either both static or dynamic."
                )

        if self.format == QFormat.QLINEAR:
            self._check_qlinear_format_constraints()

        return self

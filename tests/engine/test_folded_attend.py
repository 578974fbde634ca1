"""Scale-folded int8-KV attend + kernel-layout scale baking.

The engine's quantized-cache attend folds the per-(token, head) K/V scales
into the score columns / attention weights instead of materializing a
dequantized cache (models/gemma3.py QuantizedKV branch), and
``prepare_kernel_scales`` pre-bakes packed GROUP scale/zp into the Pallas
kernels' (G_pad/2, 2, N) pair layout at engine load. Both must be pure
layout/scheduling changes: logits and tokens must match the unfolded,
unbaked formulations.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.engine import InferenceEngine
from onnx_quantize_tpu.engine.engine import prepare_kernel_scales
from onnx_quantize_tpu.engine.kv_cache import QuantizedKV, read_kv
from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config


@pytest.fixture(scope="module")
def quantized_tiny():
    model = Gemma3(Gemma3Config.tiny())
    params = model.init(jax.random.key(0))
    qconfig = oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", group_size=16))
    qparams, _ = oqt.quantize(model, params, qconfig)
    return model, qparams


def _run_engine(model, params, ids, lengths, steps=5, **kw):
    engine = InferenceEngine(model, params, max_batch=2, max_seq=32, **kw)
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    toks = np.asarray(np.argmax(logits, -1), np.int32)
    cache, gen = engine.decode_multi(cache, toks, steps=steps)
    return np.asarray(logits), np.asarray(gen)


class TestFoldedAttend:
    def test_matches_manual_dequant_attend(self, rng, quantized_tiny):
        """Folded attend == softmax over explicitly dequantized K/V."""
        model, qparams = quantized_tiny
        B, S, Hkv, D = 2, 32, model.cfg.num_kv_heads, model.cfg.head_dim
        Hq = model.cfg.num_heads
        k_q = jnp.asarray(rng.integers(-127, 128, (B, S, Hkv, D)), jnp.int8)
        v_q = jnp.asarray(rng.integers(-127, 128, (B, S, Hkv, D)), jnp.int8)
        k_s = jnp.asarray(rng.uniform(0.001, 0.02, (B, S, Hkv)), jnp.float32)
        v_s = jnp.asarray(rng.uniform(0.001, 0.02, (B, S, Hkv)), jnp.float32)
        q = jnp.asarray(rng.standard_normal((B, 1, Hq * D)), jnp.float32)
        mask = jnp.zeros((B, 1, 1, S), jnp.float32)

        attn = model.blocks[0].attn
        kv = QuantizedKV(k_q, v_q, k_s, v_s)
        got = attn(
            qparams["layers.0"]["attn"], q,
            positions=jnp.full((B, 1), S - 1, jnp.int32), mask=mask,
            kv_write=lambda layer, k, v: kv,
        )

        # Oracle: dequantize wholesale, then the same attend.
        k_f = (k_q.astype(jnp.float32) * k_s[..., None]).astype(jnp.float32)
        v_f = (v_q.astype(jnp.float32) * v_s[..., None]).astype(jnp.float32)
        want = attn(
            qparams["layers.0"]["attn"], q,
            positions=jnp.full((B, 1), S - 1, jnp.int32), mask=mask,
            kv_write=lambda layer, k, v: (k_f, v_f),
        )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), atol=3e-3, rtol=3e-3
        )

    def test_engine_tokens_invariant(self, quantized_tiny):
        """int8-KV engine (folded attend) decodes the same tokens as before."""
        model, qparams = quantized_tiny
        rng = np.random.default_rng(0)
        ids = rng.integers(1, model.cfg.vocab_size, size=(2, 8)).astype(np.int32)
        lengths = np.array([8, 5], np.int32)
        logits_q, gen_q = _run_engine(model, qparams, ids, lengths, kv_quant=True)
        logits_f, gen_f = _run_engine(model, qparams, ids, lengths, kv_quant=False)
        # int8 KV is lossy vs fp KV, but greedy tokens agree on this model.
        np.testing.assert_array_equal(gen_q, gen_f)
        np.testing.assert_allclose(logits_q, logits_f, atol=0.15, rtol=0.1)


class TestPreparedScales:
    def test_layout_and_oracle_equivalence(self, quantized_tiny):
        model, qparams = quantized_tiny
        from onnx_quantize_tpu.nn.qtensor import QTensor
        from onnx_quantize_tpu.ops.reference import dequantize_weight

        prepared = prepare_kernel_scales(qparams)
        n_baked = 0
        leaves = jax.tree.leaves(
            prepared, is_leaf=lambda x: isinstance(x, QTensor)
        )
        originals = jax.tree.leaves(
            qparams, is_leaf=lambda x: isinstance(x, QTensor)
        )
        for orig, baked in zip(originals, leaves):
            if not isinstance(baked, QTensor) or not baked.meta.packed:
                continue
            n_baked += 1
            assert baked.scale.ndim == 3 and baked.scale.shape[1] == 2
            # The oracle must see identical dequantized weights either way.
            np.testing.assert_array_equal(
                np.asarray(dequantize_weight(orig)),
                np.asarray(dequantize_weight(baked)),
            )
        assert n_baked > 0

    def test_prepared_params_same_logits(self, quantized_tiny):
        """Kernel path on baked scales == kernel path on logical scales."""
        model, qparams = quantized_tiny
        ids = np.arange(12, dtype=np.int32).reshape(2, 6) % model.cfg.vocab_size
        want = np.asarray(model(qparams, ids))
        got = np.asarray(model(prepare_kernel_scales(qparams), ids))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    def test_idempotent(self, quantized_tiny):
        _, qparams = quantized_tiny
        once = prepare_kernel_scales(qparams)
        twice = prepare_kernel_scales(once)
        for a, b in zip(jax.tree.leaves(once), jax.tree.leaves(twice)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

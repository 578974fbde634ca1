"""Engine tensor-parallel path: whole-model shard_map over a (data, model)
mesh must reproduce the single-device engine."""

import numpy as np
import pytest

import jax

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu import ops
from onnx_quantize_tpu.engine import InferenceEngine
from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu.parallel import make_mesh


def _quantized_tiny(hidden=128, inter=128, heads=4, head_dim=32, vocab=256,
                    gs=16, layers=2, kv_heads=1):
    cfg = Gemma3Config.tiny(
        hidden_size=hidden, intermediate_size=inter, num_layers=layers,
        num_heads=heads, num_kv_heads=kv_heads, head_dim=head_dim,
        vocab_size=vocab,
    )
    model = Gemma3(cfg)
    params = model.init(jax.random.key(0))
    qconfig = oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", group_size=gs))
    qparams, _ = oqt.quantize(model, params, qconfig)
    return model, qparams


def _run_engine(model, params, mesh=None, batch=2, steps=3, max_seq=32):
    engine = InferenceEngine(model, params, max_batch=batch, max_seq=max_seq,
                             kv_quant=True, mesh=mesh)
    rng = np.random.default_rng(7)
    ids = rng.integers(1, model.cfg.vocab_size, size=(batch, 8)).astype(np.int32)
    lengths = np.full((batch,), 8, np.int32)
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    first = np.asarray(np.argmax(logits, -1), np.int32)
    cache, generated = engine.decode_multi(cache, first, steps=steps)
    return np.asarray(logits), first, np.asarray(generated), np.asarray(cache["lengths"])


def test_tp_engine_matches_single_device():
    """TP (data=2 x model=4) prefill + scan'd decode == single-device engine."""
    model, qparams = _quantized_tiny()
    mesh = make_mesh(model_parallel=4)
    assert mesh.shape == {"data": 2, "model": 4}

    logits_1, first_1, gen_1, len_1 = _run_engine(model, qparams)
    logits_tp, first_tp, gen_tp, len_tp = _run_engine(model, qparams, mesh=mesh)

    np.testing.assert_allclose(logits_tp, logits_1, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(first_tp, first_1)
    np.testing.assert_array_equal(gen_tp, gen_1)
    np.testing.assert_array_equal(len_tp, len_1)


def test_tp_engine_runs_pallas_kernels():
    """The TP engine must execute the W4 kernel per shard (in the Pallas
    interpreter, asked for explicitly on the CPU): local N=128 is covered by
    the kernel for every projection. Sharded output must still match the jnp
    single-device oracle."""
    model, qparams = _quantized_tiny(
        hidden=128, inter=512, heads=8, head_dim=64, vocab=512, gs=16,
    )
    mesh = make_mesh(model_parallel=4)

    logits_1, first_1, gen_1, _ = _run_engine(model, qparams, steps=2)
    ops.set_impl("pallas", interpret=True)
    try:
        logits_tp, first_tp, gen_tp, _ = _run_engine(model, qparams, mesh=mesh, steps=2)
    finally:
        ops.set_impl("auto")

    np.testing.assert_allclose(logits_tp, logits_1, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(first_tp, first_1)
    np.testing.assert_array_equal(gen_tp, gen_1)


@pytest.mark.parametrize("kv_heads,tp", [
    (1, 2), (1, 4),   # MQA: replicate
    (2, 2), (4, 2),   # GQA: KV heads shard (kv % tp == 0)
    (4, 4),           # GQA: one KV head per device
    (2, 4),           # GQA replicate-slice: kv < tp, tp % kv == 0
])
def test_tp_engine_gqa_grid(kv_heads, tp):
    """GQA KV-head handling across the kv x tp grid:
    sharded, sliced, and replicated placements must all reproduce the
    single-device engine."""
    model, qparams = _quantized_tiny(kv_heads=kv_heads)
    mesh = make_mesh(model_parallel=tp)

    logits_1, first_1, gen_1, len_1 = _run_engine(model, qparams, steps=2,
                                                  batch=4)
    logits_tp, first_tp, gen_tp, len_tp = _run_engine(
        model, qparams, mesh=mesh, steps=2, batch=4
    )
    np.testing.assert_allclose(logits_tp, logits_1, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(first_tp, first_1)
    np.testing.assert_array_equal(gen_tp, gen_1)
    np.testing.assert_array_equal(len_tp, len_1)


@pytest.mark.parametrize("kv_heads,tp", [(1, 4), (4, 4), (2, 4)])
def test_tp_engine_fused_projections(kv_heads, tp):
    """Fused q/k/v + gate/up params run under TP (the localized columns are
    permuted into per-device [q_i|k_i|v_i] chunks; replicated KV segments
    duplicate). Must match the single-device unfused engine."""
    from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections

    model, qparams = _quantized_tiny(kv_heads=kv_heads)
    fused = fuse_gemma3_projections(qparams)
    assert any(
        "_fused_qkv" in layer.get("attn", {})
        for name, layer in fused.items() if name.startswith("layers")
    ), "fusion must actually trigger for this test to mean anything"
    mesh = make_mesh(model_parallel=tp)

    logits_1, first_1, gen_1, _ = _run_engine(model, qparams, steps=2)
    logits_tp, first_tp, gen_tp, _ = _run_engine(model, fused, mesh=mesh, steps=2)
    np.testing.assert_allclose(logits_tp, logits_1, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(first_tp, first_1)
    np.testing.assert_array_equal(gen_tp, gen_1)


def test_tp_engine_eos_freeze_matches():
    """EOS done-mask semantics survive the shard_map wrapping."""
    model, qparams = _quantized_tiny()
    mesh = make_mesh(model_parallel=4)
    engine = InferenceEngine(model, qparams, max_batch=2, max_seq=32, mesh=mesh)
    ids = np.array([[1, 2, 3, 4, 5, 6, 7, 8]] * 2, np.int32)
    lengths = np.full((2,), 8, np.int32)
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    first = np.asarray(np.argmax(logits, -1), np.int32)
    cache, gen = engine.decode_multi(cache, first, steps=4)
    eos = int(np.asarray(gen)[0, 0])
    cache2, logits2 = engine.prefill(engine.new_cache(), ids, lengths)
    first2 = np.asarray(np.argmax(logits2, -1), np.int32)
    cache2, gen2 = engine.decode_multi(cache2, first2, steps=4, eos_token_id=eos)
    assert all(int(t) == eos for t in np.asarray(gen2)[0, 1:])
    assert int(np.asarray(cache2["lengths"])[0]) == 8 + 1

"""MoE family: routing semantics, quantization, stacking, calibration taps.

The reference quantizes every MatMul/Gemm site it finds — an MoE model is a
model with E× more of them. These tests pin (a) the router math against a
per-token python oracle, (b) that the dense-masked execution is exact (combine
weights ignore zeroed expert outputs), (c) that quantize()/fusion/stacking
compose without changing outputs, and (d) that per-expert calibration taps see
only routed tokens (the property GPTQ/AWQ/SmoothQuant correctness rests on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.models.gemma3 import Gemma3, fuse_gemma3_projections
from onnx_quantize_tpu.models.moe import (
    fuse_moe_experts,
    stack_moe_experts,
    tiny_moe_config,
)
from onnx_quantize_tpu.nn.module import Context


def _model(**kw):
    cfg = tiny_moe_config(**kw)
    model = Gemma3(cfg)
    params = model.init(jax.random.key(0))
    return cfg, model, params


def _ids(rng, batch=2, seq=8, vocab=256):
    return rng.integers(1, vocab, size=(batch, seq)).astype(np.int32)


def _moe_oracle(cfg, mlp_params, experts_fn, x):
    """Per-token routing oracle: gather → compute → weighted scatter."""
    logits = x @ np.asarray(mlp_params["router"]["w"])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    flat_x = x.reshape(-1, x.shape[-1])
    flat_p = probs.reshape(-1, cfg.num_experts)
    flat_o = out.reshape(-1, x.shape[-1])
    for t in range(flat_x.shape[0]):
        top = np.argsort(-flat_p[t])[: cfg.num_experts_per_tok]
        w = flat_p[t, top]
        if cfg.norm_topk_prob:
            w = w / w.sum()
        for e, we in zip(top, w):
            flat_o[t] += we * experts_fn(int(e), flat_x[t : t + 1])[0]
    return out


class TestRouting:
    def test_combine_matches_per_token_oracle(self, rng):
        cfg, model, params = _model(norm_topk_prob=True)
        mlp_module = model.blocks[0].mlp
        mlp_params = params["layers.0"]["mlp"]
        x = rng.standard_normal((2, 5, cfg.hidden_size)).astype(np.float32)

        def expert_fn(e, xe):
            return np.asarray(
                mlp_module.experts[e](mlp_params[f"experts.{e}"], jnp.asarray(xe))
            )

        got = np.asarray(mlp_module(mlp_params, jnp.asarray(x)))
        want = _moe_oracle(cfg, mlp_params, expert_fn, x)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    def test_no_norm_topk(self, rng):
        """Qwen convention: combine weights are raw softmax probabilities."""
        cfg, model, params = _model(norm_topk_prob=False)
        mlp_module = model.blocks[0].mlp
        mlp_params = params["layers.0"]["mlp"]
        x = rng.standard_normal((1, 4, cfg.hidden_size)).astype(np.float32)

        def expert_fn(e, xe):
            return np.asarray(
                mlp_module.experts[e](mlp_params[f"experts.{e}"], jnp.asarray(xe))
            )

        got = np.asarray(mlp_module(mlp_params, jnp.asarray(x)))
        want = _moe_oracle(cfg, mlp_params, expert_fn, x)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    def test_shared_expert_sigmoid_gate(self, rng):
        cfg, model, params = _model(shared_expert_size=48)
        mlp_module = model.blocks[0].mlp
        mlp_params = params["layers.0"]["mlp"]
        x = jnp.asarray(rng.standard_normal((2, 3, cfg.hidden_size)), jnp.float32)
        got = mlp_module(mlp_params, x)

        no_shared = {k: v for k, v in mlp_params.items()
                     if k not in ("shared", "shared_gate")}
        cfg0 = tiny_moe_config()
        base_mlp = Gemma3(cfg0).blocks[0].mlp
        base = base_mlp(no_shared, x)
        gate = jax.nn.sigmoid(
            (x @ mlp_params["shared_gate"]["w"]).astype(jnp.float32)
        )
        shared = mlp_module.shared(mlp_params["shared"], x)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(base + gate * shared), atol=1e-5
        )


class TestQuantizeAndStack:
    def test_sites_discovered(self):
        cfg, model, params = _model(shared_expert_size=48)
        names = [s.name for s in model.linear_sites()]
        for e in range(cfg.num_experts):
            for proj in ("gate_proj", "up_proj", "down_proj"):
                assert f"layers.0.mlp.experts.{e}.{proj}" in names
        assert "layers.0.mlp.router" in names
        assert "layers.0.mlp.shared.gate_proj" in names
        assert "layers.0.mlp.shared_gate" in names

    @pytest.mark.parametrize("dtype,group", [("uint4", 16), ("int8", -1)])
    def test_quantized_close_to_fp(self, rng, dtype, group):
        cfg, model, params = _model()
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(
                dtype=dtype,
                group_size=group if group > 0 else None,
                strategy=None if group > 0 else "channel",
            ),
            ignore=[r"\.router$"],
        )
        qparams, plan = oqt.quantize(model, params, qc)
        ids = _ids(rng)
        fp = np.asarray(model(params, ids))
        q = np.asarray(model(qparams, ids))
        assert np.isfinite(q).all()
        rel = np.abs(q - fp).mean() / (np.abs(fp).mean() + 1e-9)
        assert rel < (0.5 if dtype == "uint4" else 0.1)

    def test_fuse_and_stack_are_exact(self, rng):
        cfg, model, params = _model(shared_expert_size=48)
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
            ignore=[r"\.router$", r"\.shared_gate$"],
        )
        qparams, _ = oqt.quantize(model, params, qc)
        ids = _ids(rng)
        base = np.asarray(model(qparams, ids))
        fused = fuse_gemma3_projections(qparams)
        assert "_fused_gate_up" in fused["layers.0"]["mlp"]["experts.0"]
        stacked = stack_moe_experts(fused)
        mlp = stacked["layers.0"]["mlp"]
        assert "_stacked_experts" in mlp and "experts.0" not in mlp
        assert mlp["_stacked_experts"]["gate_up"]["w"].data.shape[0] == cfg.num_experts
        np.testing.assert_array_equal(np.asarray(model(fused, ids)), base)
        np.testing.assert_array_equal(np.asarray(model(stacked, ids)), base)

    def test_stack_unfused_fp(self, rng):
        """Stacking also serves unfused fp experts (gate/up/down entries)."""
        cfg, model, params = _model()
        ids = _ids(rng)
        base = np.asarray(model(params, ids))
        stacked = stack_moe_experts(params)
        st = stacked["layers.0"]["mlp"]["_stacked_experts"]
        assert set(st) == {"gate", "up", "down"}
        np.testing.assert_allclose(
            np.asarray(model(stacked, ids)), base, atol=1e-6
        )

    def test_fused_experts_layout_matches_loop(self, rng):
        """The concatenated-experts layout (one fat-N gate_up + one deep-K
        down with the combine folded into the accumulator) must match the
        per-expert loop within f32 reduction-order tolerance."""
        cfg, model, params = _model(shared_expert_size=48)
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
            ignore=[r"\.router$", r"\.shared_gate$"],
        )
        qparams, _ = oqt.quantize(model, params, qc)
        gfused = fuse_gemma3_projections(qparams)
        ids = _ids(rng)
        base = np.asarray(model(gfused, ids))
        efused = fuse_moe_experts(gfused)
        mlp = efused["layers.0"]["mlp"]
        assert "_fused_experts" in mlp and "experts.0" not in mlp
        gu = mlp["_fused_experts"]["gate_up"]["w"]
        dn = mlp["_fused_experts"]["down"]["w"]
        inter = cfg.moe_intermediate_size
        assert gu.meta.shape == (cfg.hidden_size, cfg.num_experts * 2 * inter)
        assert dn.meta.shape == (cfg.num_experts * inter, cfg.hidden_size)
        out = np.asarray(model(efused, ids))
        np.testing.assert_allclose(out, base, atol=1e-5, rtol=1e-5)

    def test_fused_experts_fp(self, rng):
        cfg, model, params = _model()
        ids = _ids(rng)
        base = np.asarray(model(params, ids))
        efused = fuse_moe_experts(fuse_gemma3_projections(params))
        np.testing.assert_allclose(
            np.asarray(model(efused, ids)), base, atol=1e-5, rtol=1e-5
        )

    def test_fuse_experts_skipped_with_prescale(self, rng):
        """AWQ prescales make per-expert gate/up unfusable; the transform
        must leave the loop layout instead of mis-fusing."""
        cfg, model, params = _model()
        data = _ids(rng, batch=4, seq=8)
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
            preprocessors=[oqt.AwqConfig()],
            ignore=[r"\.router$"],
            calibration_data=data,
            calibration_params=oqt.CalibrationParams(num_samples=4, batch_size=2),
        )
        qparams, _ = oqt.quantize(model, params, qc)
        efused = fuse_moe_experts(fuse_gemma3_projections(qparams))
        mlp = efused["layers.0"]["mlp"]
        assert "_fused_experts" not in mlp
        assert "experts.0" in mlp
        ids = _ids(rng)
        np.testing.assert_array_equal(
            np.asarray(model(efused, ids)), np.asarray(model(qparams, ids))
        )

    def test_ragged_prefill_matches_loop(self, rng):
        """The sorted ragged_dot path (exact routing, compute proportional
        to routed tokens) matches the dense-masked loop — from both the
        stacked and the concatenated layout."""
        cfg, model, params = _model()
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
            ignore=[r"\.router$"],
        )
        qparams, _ = oqt.quantize(model, params, qc)
        gfused = fuse_gemma3_projections(qparams)
        ids = _ids(rng, batch=4, seq=16)
        base = np.asarray(model(gfused, ids))
        for layout in (stack_moe_experts, fuse_moe_experts):
            tree = layout(gfused)
            for block in model.blocks:
                block.mlp.use_ragged_prefill = True
            try:
                out = np.asarray(model(tree, ids))
            finally:
                for block in model.blocks:
                    block.mlp.use_ragged_prefill = "auto"
            np.testing.assert_allclose(
                out, base, atol=2e-5, rtol=2e-5,
                err_msg=f"ragged path diverges for {layout.__name__}",
            )

    @pytest.mark.parametrize("mode, want", [
        ("auto", False), (True, True), (False, False),
    ])
    def test_ragged_prefill_rule(self, mode, want):
        """Ragged prefill is one backend-neutral rule: only an explicit
        ``use_ragged_prefill=True`` takes it; "auto" keeps dense-masked."""
        cfg, model, params = _model()
        mlp = model.blocks[0].mlp
        layout = {"gate_up": {"w": params["layers.0"]["mlp"]["experts.0"][
            "gate_proj"]["w"]}}  # fp site dict: _ragged_compatible trivially
        mlp.use_ragged_prefill = mode
        try:
            assert mlp._ragged_ok(layout) is want
            assert mlp._ragged_ok(None) is False
        finally:
            mlp.use_ragged_prefill = "auto"

    def test_ragged_falls_back_on_act_quant(self, rng):
        """The ragged path runs plain fp grouped matmuls — configs with
        activation quantization must fall back to the dense-masked path
        (whose quantized_matmul applies the act fake-quant), even when
        use_ragged_prefill is forced on."""
        cfg, model, params = _model()
        data = _ids(rng, batch=4, seq=8)
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="int8", strategy="channel"),
            input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
            calibration_data=data,
            calibration_params=oqt.CalibrationParams(num_samples=4, batch_size=2),
            ignore=[r"\.router$"],
        )
        qparams, _ = oqt.quantize(model, params, qc)
        stacked = stack_moe_experts(fuse_gemma3_projections(qparams))
        mlp_module = model.blocks[0].mlp
        experts = stacked["layers.0"]["mlp"]["_stacked_experts"]
        assert not mlp_module._ragged_compatible(experts)
        ids = _ids(rng, batch=4, seq=16)
        base = np.asarray(model(stacked, ids))
        for block in model.blocks:
            block.mlp.use_ragged_prefill = True
        try:
            out = np.asarray(model(stacked, ids))
        finally:
            for block in model.blocks:
                block.mlp.use_ragged_prefill = "auto"
        np.testing.assert_array_equal(out, base)

    def test_stack_rejects_mismatched_quantization(self, rng):
        cfg, model, params = _model()
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
            # Quantize only ONE expert: stacking must reject the mix.
            ignore=[r"\.router$", r"experts\.[123]\."],
        )
        qparams, _ = oqt.quantize(model, params, qc)
        with pytest.raises(ValueError, match="quantized identically|mix quantized"):
            stack_moe_experts(qparams)


class TestCalibrationTaps:
    def test_expert_taps_see_only_routed_tokens(self, rng):
        """The dense-masked scheme zeroes unrouted rows BEFORE the expert's
        Linear sites — the per-expert tapped input (what GPTQ's Hessian and
        SmoothQuant's maxima consume) is exactly the routed token set."""
        cfg, model, params = _model()
        ids = _ids(rng, batch=1, seq=6)
        ctx = Context(taps={}, tap_inputs=True)
        model(params, ids, ctx=ctx)

        # Recompute the routing for layer 0 to find unrouted tokens.
        mlp_module = model.blocks[0].mlp
        mlp_params = params["layers.0"]["mlp"]
        tapped_router = ctx.taps["layers.0.mlp.router"]["input"]
        top_p, top_i = mlp_module._routing(mlp_params, tapped_router, None)
        combine = np.asarray(
            mlp_module._combine_weights(top_p, top_i, cfg.num_experts)
        )
        for e in range(cfg.num_experts):
            tap = np.asarray(
                ctx.taps[f"layers.0.mlp.experts.{e}.gate_proj"]["input"]
            )
            unrouted = combine[..., e] == 0
            assert (tap[unrouted] == 0).all(), (
                f"expert {e} gate tap leaks unrouted tokens"
            )
            if (~unrouted).any():
                assert np.abs(tap[~unrouted]).max() > 0

    def test_gptq_on_moe_experts(self, rng):
        """GPTQ over an MoE model: each expert's Hessian accumulates only its
        routed tokens (zeroed rows contribute zero to X^T X) — the property
        the dense-masked taps guarantee. Must run end-to-end and not blow up
        output error vs RTN."""
        cfg, model, params = _model()
        data = _ids(rng, batch=4, seq=8)
        ids = _ids(rng)
        fp = np.asarray(model(params, ids))

        def run(algorithm):
            qc = oqt.QConfig(
                weights=oqt.QWeightArgs(
                    dtype="uint4", group_size=16, algorithm=algorithm,
                ),
                ignore=[r"\.router$"],
                calibration_data=data,
                calibration_params=oqt.CalibrationParams(
                    num_samples=4, batch_size=2
                ),
            )
            qparams, _ = oqt.quantize(model, params, qc)
            q = np.asarray(model(qparams, ids))
            return float(np.abs(q - fp).mean())

        err_gptq = run(oqt.GPTQConfig(block_size=16))
        err_rtn = run(None)
        assert np.isfinite(err_gptq)
        assert err_gptq < 1.5 * err_rtn

    def test_calibrated_static_act_quantization(self, rng):
        """End-to-end: static act quant over an MoE model calibrates and runs."""
        cfg, model, params = _model()
        data = _ids(rng, batch=4, seq=8)
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="int8", strategy="channel"),
            input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
            calibration_params=oqt.CalibrationParams(num_samples=4, batch_size=2),
            calibration_data=data,
            ignore=[r"\.router$"],
        )
        qparams, plan = oqt.quantize(model, params, qc)
        out = np.asarray(model(qparams, _ids(rng)))
        assert np.isfinite(out).all()


class TestEngine:
    def test_speculative_decoding_with_moe_target(self):
        """Speculative decoding composes with an MoE target (fused-expert
        layout): output must equal the target engine's own greedy stream."""
        from onnx_quantize_tpu.engine import InferenceEngine, SpeculativeDecoder

        cfg, model, params = _model()
        qparams, _ = oqt.quantize(
            model, params,
            oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
                        ignore=[r"\.router$"]),
        )
        fused = fuse_moe_experts(fuse_gemma3_projections(qparams))
        prompts = [[5, 9, 17, 3], [11, 2]]
        base = InferenceEngine(model, fused, max_batch=2, max_seq=64,
                               kv_quant=True).generate(prompts, max_new_tokens=8)
        spec = SpeculativeDecoder(
            InferenceEngine(model, fused, max_batch=2, max_seq=64, kv_quant=True),
            InferenceEngine(model, fused, max_batch=2, max_seq=64, kv_quant=True),
            k=3,
        )
        got = spec.generate(prompts, max_new_tokens=8)
        assert got == base

    def test_moe_engine_prefill_decode(self, rng):
        cfg, model, params = _model(shared_expert_size=48)
        qc = oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
            ignore=[r"\.router$", r"\.shared_gate$"],
        )
        qparams, _ = oqt.quantize(model, params, qc)
        stacked = stack_moe_experts(fuse_gemma3_projections(qparams))

        from onnx_quantize_tpu.engine import InferenceEngine

        ids = _ids(rng, batch=2, seq=8)
        lengths = np.full((2,), 8, np.int32)
        # kv_quant=False: the engine logits are compared EXACTLY against the
        # no-cache forward below (int8 KV would add cache quantization error).
        engine = InferenceEngine(model, stacked, max_batch=2, max_seq=32,
                                 kv_quant=False)
        cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
        first = np.asarray(np.argmax(logits, -1), np.int32)
        cache, gen = engine.decode_multi(cache, first, steps=4)
        assert np.asarray(gen).shape == (2, 4)

        # Engine logits match the no-cache forward at the last prompt token.
        full = np.asarray(model(stacked, ids))[:, -1]
        np.testing.assert_allclose(
            np.asarray(logits), full, atol=2e-4, rtol=1e-4
        )

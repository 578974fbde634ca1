"""Headline benchmark: Gemma-3 W4(g128) decode throughput on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, "device": ...}

The measurement is the serving configuration from BASELINE.json config 4/5:
Gemma-3 (270M by default), weights INT4 group-128 (RTN; the fused W4 decode
kernel), int8 per-channel lm_head, int8 KV cache, batched greedy decode
through the engine. ``vs_baseline`` is the speedup over the same engine
running bf16 weights and a bf16 KV cache — the reference publishes no
throughput numbers (BASELINE.md), so bf16 is the baseline the quantized path
must beat.

Runs only on a GPU: with no GPU it exits non-zero and says why. The line
names the device (JAX's platform, kind and count) and the card's name and
power limit (``nvidia-smi``), since a card set below its maximum power runs
slower under load.
"""

import dataclasses
import json
import os
import time

import numpy as np

# Mixtral-convention 8x top-2 MoE (~1.2B params, ~0.36B active).
MOE_CONFIG = dict(
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=2816,
    shared_expert_size=0, norm_topk_prob=True, vocab_size=32_768,
    hidden_size=1024, intermediate_size=2816, num_layers=16, num_heads=8,
    num_kv_heads=2, head_dim=128, rope_theta=1_000_000.0,
)


def build_arm(model_cfg, quantized: bool, init_device, head: str = "int8"):
    """The serving recipe: (model, engine-layout params) for one arm.

    Quantized: W4 group-128 transformer projections, then the lm_head in a
    second pass (per-site config mixing via ignore patterns): int8
    per-channel, or W4 g64 with ``head="w4"``. Both arms get the horizontal
    q/k/v + gate/up fusion; MoE experts are concatenated into one fat-N
    gate_up and one deep-K down per layer."""
    import jax

    import onnx_quantize_tpu as oqt
    from onnx_quantize_tpu.models.gemma3 import Gemma3, fuse_gemma3_projections

    model = Gemma3(model_cfg)
    moe = model_cfg.num_experts > 0
    with jax.default_device(init_device):
        params = model.init(jax.random.key(0))
        if quantized:
            qconfig = oqt.QConfig(
                weights=oqt.QWeightArgs(dtype="uint4", group_size=128),
                ignore=["lm_head"] + ([r"\.router$"] if moe else []),
            )
            params, _ = oqt.quantize(model, params, qconfig)
            if head == "w4":
                head_cfg = oqt.QConfig(
                    weights=oqt.QWeightArgs(dtype="uint4", group_size=64),
                    ignore=[r"^layers\."],
                )
            else:
                head_cfg = oqt.QConfig(
                    weights=oqt.QWeightArgs(dtype="int8", group_size=-1,
                                            symmetric=True),
                    ignore=[r"^layers\."],
                )
            params, _ = oqt.quantize(model, params, head_cfg)
        params = fuse_gemma3_projections(params)
        if moe:
            from onnx_quantize_tpu.engine import prepare_kernel_scales
            from onnx_quantize_tpu.models.moe import fuse_moe_experts

            params = fuse_moe_experts(prepare_kernel_scales(params))
    return model, params


def _decode_rate(model, params, device, batch=8, prompt_len=128, steps=64,
                 kv_quant=True, max_seq=512, repeats=5):
    """Decode tokens/s via the SLOPE between two scan lengths (``steps`` and
    ``4*steps``): the fixed cost of a call cancels."""
    import jax
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from onnx_quantize_tpu.engine import InferenceEngine

    params = jtu.tree_map(lambda a: jax.device_put(a, device), params)
    engine = InferenceEngine(
        model, params, max_batch=batch, max_seq=max_seq, kv_quant=kv_quant,
        dtype=model.cfg.jnp_dtype if model.cfg.dtype != "float32" else jnp.float32,
    )
    rng = np.random.default_rng(0)
    ids = rng.integers(1, model.cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    lengths = np.full((batch,), prompt_len, np.int32)

    cache = engine.new_cache()
    cache, logits = engine.prefill(cache, ids, lengths)
    tokens = np.asarray(np.argmax(logits, axis=-1), np.int32)

    steps_lo, steps_hi = steps, 4 * steps

    # Warm BOTH scan programs.
    cache, generated = engine.decode_multi(cache, tokens, steps=steps_lo)
    tokens = np.asarray(generated)[:, -1]
    cache, generated = engine.decode_multi(cache, tokens, steps=steps_hi)
    tokens = np.asarray(generated)[:, -1]

    # Median of N timed repeats per scan length. Repeats reuse the warmed
    # programs and cache slots (KV writes past max_seq drop, identically for
    # both arms).
    def timed(n_steps):
        nonlocal cache, tokens
        samples = []
        for _ in range(repeats):
            t0 = time.time()
            cache, generated = engine.decode_multi(cache, tokens, steps=n_steps)
            jax.block_until_ready(generated)
            samples.append(time.time() - t0)
        tokens = np.asarray(generated)[:, -1]
        return samples

    t_lo = timed(steps_lo)
    t_hi = timed(steps_hi)
    extra = batch * (steps_hi - steps_lo)
    pairs = [extra / (hi - lo) for lo, hi in zip(sorted(t_lo), sorted(t_hi))]
    return (
        float(np.median(pairs)),
        float(np.min(pairs)),
        float(np.max(pairs)),
    )


def main():
    from onnx_quantize_tpu.utils.device import (
        card_name_and_power_limit,
        device_record,
        require_gpu,
    )

    device = require_gpu()
    from onnx_quantize_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from onnx_quantize_tpu.models.gemma3 import GEMMA3_1B, GEMMA3_4B, GEMMA3_270M

    cpu = jax.devices("cpu")[0]
    # OQT_BENCH_MODEL=1b/4b/moe benches the larger family members and the
    # MoE config; the default stays the 270M flagship.
    model_name = os.environ.get("OQT_BENCH_MODEL", "270m").lower()
    if model_name == "moe":
        from onnx_quantize_tpu.models.moe import moe_config

        base = moe_config(**MOE_CONFIG)
    else:
        base = {"1b": GEMMA3_1B, "4b": GEMMA3_4B}.get(model_name, GEMMA3_270M)
    cfg = dataclasses.replace(base, dtype="bfloat16")
    # OQT_BENCH_BATCH overrides for batch-scaling experiments.
    batch, prompt_len, steps, max_seq = 32, 128, 64, 512
    batch = int(os.environ.get("OQT_BENCH_BATCH", batch))

    head = "w4" if model_name == "4b" else "int8"
    # OQT_BENCH_KV=int4 runs the quantized arm on the packed int4 KV cache
    # (kv_cache.py); default int8. OQT_BENCH_SEQ stretches the context
    # (prompt fills all but `steps` of it) for KV-bound regimes.
    kv_mode = os.environ.get("OQT_BENCH_KV", "int8")
    if "OQT_BENCH_SEQ" in os.environ:
        max_seq = int(os.environ["OQT_BENCH_SEQ"])
        prompt_len = max_seq - 4 * steps
    model_q, params_q = build_arm(cfg, quantized=True, init_device=cpu, head=head)
    rate_q, lo_q, hi_q = _decode_rate(
        model_q, params_q, device, batch=batch, prompt_len=prompt_len,
        steps=steps, max_seq=max_seq, kv_quant=kv_mode,
    )

    model_f, params_f = build_arm(cfg, quantized=False, init_device=cpu)
    rate_f, lo_f, hi_f = _decode_rate(
        model_f, params_f, device, batch=batch, prompt_len=prompt_len,
        steps=steps, kv_quant=False, max_seq=max_seq,
    )

    # One JSON line; medians for both arms plus per-arm spread.
    print(
        json.dumps(
            {
                "metric": (
                    "moe_8x2816_top2_w4g128_decode_tokens_per_sec_per_chip"
                    if model_name == "moe"
                    else f"gemma3_{model_name}_w4g128_decode_tokens_per_sec_per_chip"
                ),
                "value": round(rate_q, 1),
                "unit": "tokens/s",
                "vs_baseline": round(rate_q / rate_f, 3),
                "baseline_bf16_tokens_per_sec": round(rate_f, 1),
                "quantized_spread": [round(lo_q, 1), round(hi_q, 1)],
                "baseline_spread": [round(lo_f, 1), round(hi_f, 1)],
                "device": device_record(),
                "card": card_name_and_power_limit(),
            }
        )
    )


if __name__ == "__main__":
    main()

"""Serve a quantized Gemma-3 with continuous batching (the fast path).

End-to-end serving demo: quantize (W4 g128 body + int8 lm_head + int8 KV),
build the engine, and stream a mixed workload — heterogeneous prompts,
budgets, temperatures, and EOS ids — through the chunked scheduler. With
``chunk > 1`` every scheduler round is ONE compiled device program
(``engine.serve_chunk``): admission prefill, per-slot sampling, and ``chunk``
decode steps, returning a single packed result blob.

Usage:
    python examples/serving.py [--chunk 16] [--requests 32] [--tiny]

``--tiny`` runs a toy config (CPU-friendly smoke); the default builds the
real 270M shapes and belongs on an accelerator.
"""

import argparse
import dataclasses
import time

import numpy as np

import jax
import jax.numpy as jnp

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.engine import ContinuousBatchingScheduler, InferenceEngine
from onnx_quantize_tpu.engine.sampling import SamplingParams
from onnx_quantize_tpu.models.gemma3 import (
    GEMMA3_270M,
    Gemma3,
    Gemma3Config,
    fuse_gemma3_projections,
)


def build(tiny: bool):
    cfg = (
        Gemma3Config.tiny(hidden_size=128, intermediate_size=256, num_layers=2,
                          num_heads=2, num_kv_heads=1, head_dim=64, vocab_size=512)
        if tiny
        else dataclasses.replace(GEMMA3_270M, dtype="bfloat16")
    )
    model = Gemma3(cfg)
    params = model.init(jax.random.key(0))
    body = oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=32 if tiny else 128),
        ignore=["lm_head"],
    )
    params, _ = oqt.quantize(model, params, body)
    head = oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."],
    )
    params, _ = oqt.quantize(model, params, head)
    params = fuse_gemma3_projections(params)
    return model, params


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunk", type=int, default=16)
    parser.add_argument("--pipeline", type=int, default=8,
                        help="serve rounds dispatched before reading results "
                        "(hides the host round-trip behind device compute; "
                        "admissions are planned from budgets so freed slots "
                        "refill mid-group, and the group's results come back "
                        "in one stacked fetch)")
    parser.add_argument("--requests", type=int, default=32)
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--max-seq", type=int, default=256)
    parser.add_argument("--tiny", action="store_true")
    args = parser.parse_args()

    model, params = build(args.tiny)
    engine = InferenceEngine(
        model, params, max_batch=args.slots, max_seq=args.max_seq,
        kv_quant=True,
        dtype=jnp.bfloat16 if model.cfg.dtype == "bfloat16" else jnp.float32,
    )
    sched = ContinuousBatchingScheduler(engine, chunk=args.chunk,
                                        pipeline=args.pipeline)

    rng = np.random.default_rng(0)
    eos = int(rng.integers(1, model.cfg.vocab_size))
    for i in range(args.requests):
        prompt = list(rng.integers(1, model.cfg.vocab_size,
                                   size=int(rng.integers(8, 64))))
        sched.submit(
            prompt,
            max_new_tokens=int(rng.integers(16, 48)),
            # Mixed per-request sampling runs inside ONE device program.
            sampling=(SamplingParams() if i % 3 == 0 else
                      SamplingParams(temperature=0.7, top_k=40, top_p=0.95)),
            eos_token_id=eos if i % 2 == 0 else None,
        )

    t0 = time.time()
    finished = sched.run()
    wall = time.time() - t0
    generated = sum(len(r.output) for r in finished)
    print(f"{len(finished)} requests, {generated} tokens in {wall:.2f}s "
          f"({generated / wall:.0f} tok/s incl. compile on first run)")
    for r in finished[:3]:
        print(f"  request {r.request_id}: {len(r.output)} tokens, "
              f"first 8: {r.output[:8]}")


if __name__ == "__main__":
    main()

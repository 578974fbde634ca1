"""Smoke test of the system's main path on an NVIDIA GPU.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the TP, EP, PP and CP legs only

One-GPU phases, in one process:

1. device: JAX must report a GPU; the card's name and power limit come from
   ``nvidia-smi`` in a child process that does not touch JAX.
2. kernels: the W4 decode kernel at the Gemma-3 270M/1B/4B site shapes
   (fused qkv, o, gate_up, down, lm_head), compared with the jnp oracle
   (``ops/reference.py``) and timed beside what XLA makes of it: at decode
   M = 32 everywhere, and at the 1B sites from M = 1 up to one prefill M
   (the rows that set ``ops/dispatch.py::W4_MAX_M``); the dispatch choice at
   every M; then the tests marked ``gpu``.
3. main path: ``oqt.quantize`` -> ``InferenceEngine`` (prefill, scanned
   ``decode_multi``) -> ``ContinuousBatchingScheduler`` at Gemma-3-1B
   published widths (random weights from a seed), W4 and bf16 arms; then
   W4 decode with the kernel against the two plain versions (the oracle as
   XLA compiles it, and the folded jnp formulation) at 1B, and against the
   oracle at Gemma-3-270M.
4. calibration: a static W8A8 + SmoothQuant ``quantize()`` at Gemma-3-270M
   widths whose calibration forwards must run on the GPU.
5. MoE prefill: the bench MoE config (8 x 2816, top-2) through
   ``lax.ragged_dot`` and dense-masked, each compared with the f32 forward
   and timed: the reading behind auto mode's dense-masked choice.

Any failed phase raises: the script then exits non-zero and prints no
result. The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Tolerances (each comparison runs the reference under
``jax.default_matmul_precision("highest")``, since a float32 matmul on the
GPU otherwise runs in TF32):

* kernel vs oracle, f32 x: max abs error <= 1e-4 * max|y| (only the
  summation order and the affine fold differ);
* kernel vs oracle, bf16 x: <= 1e-2 * max|y| (the oracle rounds the
  dequantized weight to bf16; the kernel keeps exact nibbles and scales in
  f32);
* engine prefill logits, bf16 engine vs the f32 forward of the same
  quantized params: <= ENGINE_BF16_TOL * max|ref| (bf16 activations rounded
  through every layer, plus the int8 KV cache in the W4 arm);
* f32 engine (no KV quantization) on the GPU's chosen path vs the jnp path:
  <= 1e-4 * max|ref| (summation order only; with an int8 KV cache an ulp
  could flip a code, 1/127 of a row's range);
* MoE prefill, f32 engine (no KV quantization) vs the f32 forward:
  <= 1e-3 * max|ref| (see MOE_F32_TOL);
* --four, sharded vs one-device f32 engine (int8 KV): <= 5e-3 * max|ref|
  (see SHARD_TOL), and greedy tokens equal.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ENGINE_BF16_TOL = 5e-2
F32_TOL = 1e-4
BF16_TOL = 1e-2
# Sharded vs one-device f32 engine with an int8 KV cache: the psum order moves
# K/V by an ulp, which can flip an int8 code (1/127 of that row's range).
SHARD_TOL = 5e-3
# f32 MoE engine prefill vs the f32 forward: summation order only, but a
# near-tied top-2 routing decision may still flip for a token.
MOE_F32_TOL = 1e-3
PREFILL_M = 16384  # the prefill row count of the kernel phase
# Row counts the kernel phase times at the 1B sites: decode batches, the
# scheduler's admission and chunked-prefill rows, one bulk prefill.
SWEEP_M = (1, 8, 32, 64, 128, 256, PREFILL_M)


def log(*parts):
    print(*parts, flush=True)


# ── helpers ──────────────────────────────────────────────────────────────


def random_w4(key, K, N, gs):
    """A packed W4 g``gs`` QTensor of random codes and scales, built on the
    device (quantizing a 262k-wide random weight on the host is slow and
    tests nothing the kernel sees)."""
    import jax
    import jax.numpy as jnp

    from onnx_quantize_tpu.core.enums import QuantizationStrategy
    from onnx_quantize_tpu.engine import prepare_kernel_scales
    from onnx_quantize_tpu.nn.qtensor import QTensor, QTensorMeta, pack_layout

    pg, n_groups = pack_layout(K, QuantizationStrategy.GROUP, gs)
    k1, k2, k3 = jax.random.split(key, 3)
    data = jax.random.randint(k1, (n_groups * pg // 2, N), 0, 256, jnp.int32)
    real_groups = -(-K // pg)
    scale = jax.random.uniform(k2, (real_groups, N), jnp.float32, 0.005, 0.02)
    zp = jax.random.randint(k3, (real_groups, N), 0, 16).astype(jnp.float32)
    meta = QTensorMeta(
        quant_type="uint4", strategy="group", group_size=gs, symmetric=False,
        reduce_range=False, shape=(K, N), packed=True, pack_group=pg,
    )
    # Codes in the padded rows past K must be zero (their x columns are).
    rows = jnp.arange(data.shape[0])[:, None]
    pair, r = rows // pg, rows % pg
    low_ok = (2 * pair) * pg + r < K
    high_ok = (2 * pair + 1) * pg + r < K
    data = jnp.where(low_ok, data & 0x0F, 0) | jnp.where(high_ok, data & 0xF0, 0)
    return prepare_kernel_scales(
        QTensor(data.astype(jnp.uint8), scale, zp, meta)
    )


def folded_w4_jnp(x, qt):
    """The plain jnp formulation of the kernel's arithmetic: unpack, convert,
    one dot per group, the same affine fold — what XLA makes of it without a
    hand-written kernel."""
    import jax.numpy as jnp

    K, N = qt.meta.shape
    gs = qt.meta.pack_group
    half = qt.data.shape[0]
    P = half // gs
    M = int(np.prod(x.shape[:-1]))
    x2 = jnp.pad(x.reshape(M, K), ((0, 0), (0, 2 * half - K))).reshape(M, P, 2, gs)
    d = qt.data.reshape(P, gs, N)
    lo = (d & 0xF).astype(x.dtype)
    hi = (d >> 4).astype(x.dtype)
    if qt.meta.qt.is_signed:
        lo, hi = (lo + 8) % 16 - 8, (hi + 8) % 16 - 8
    yl = jnp.einsum("mpk,pkn->mpn", x2[:, :, 0], lo, preferred_element_type=jnp.float32)
    yh = jnp.einsum("mpk,pkn->mpn", x2[:, :, 1], hi, preferred_element_type=jnp.float32)
    xs = jnp.sum(x2.astype(jnp.float32), -1)
    s = jnp.asarray(qt.scale).reshape(P, 2, N)
    z = jnp.asarray(qt.zero_point).reshape(P, 2, N)
    y = ((yl - xs[..., 0, None] * z[:, 0]) * s[:, 0]).sum(1) + (
        (yh - xs[..., 1, None] * z[:, 1]) * s[:, 1]).sum(1)
    return y.reshape(*x.shape[:-1], N)


def time_chain(fn, x, qt, reps):
    """Seconds per call of ``fn(x, qt)``: ``reps`` dependent calls unrolled in
    one program (a loop would add a host sync per iteration on the GPU),
    median of 3 warm runs. Each call's input and scales depend on the
    previous output, so XLA can neither merge the calls nor share one
    dequantized weight between them: every call pays what a one-shot
    prefill call pays. (Inside a decode scan XLA may keep more across steps;
    the main phase measures that end to end.) Returns (seconds, one output)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(x, qt):
        acc = jnp.zeros((), jnp.float32)
        for _ in range(reps):
            q = dataclasses.replace(qt, scale=qt.scale + acc * 1e-30)
            y = fn((x + acc * 1e-30).astype(x.dtype), q)
            acc = acc + jnp.max(y[..., :1, :1])
        return acc, fn(x, qt)

    jax.block_until_ready(chain(x, qt))
    times = []
    for _ in range(3):
        t = time.perf_counter()
        out = jax.block_until_ready(chain(x, qt))
        times.append(time.perf_counter() - t)
    return float(np.median(times)) / reps, out[1]


def rel_err(y, ref) -> float:
    import jax.numpy as jnp

    y = jnp.asarray(y, jnp.float32)
    ref = jnp.asarray(ref, jnp.float32)
    return float(jnp.max(jnp.abs(y - ref)) / jnp.max(jnp.abs(ref)))


def expect(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def site_shapes(cfg) -> dict:
    h, inter = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "qkv": (h, (hq + 2 * hkv) * d),
        "o": (hq * d, h),
        "gate_up": (h, 2 * inter),
        "down": (inter, h),
        "lm_head": (h, cfg.vocab_size),
    }


# ── phases ───────────────────────────────────────────────────────────────


def phase_kernels(card: str):
    """The W4 kernel at the 270M/1B/4B site shapes against the oracle.

    Every site: dispatch choice at each M, and kernel vs oracle time at
    decode M = 32. At the 1B sites: the f32 comparison, times at every M of
    ``SWEEP_M`` (decode batches, admission and chunked-prefill rows, one bulk
    prefill), plus the plain folded formulation at M = 32."""
    import jax
    import jax.numpy as jnp

    from onnx_quantize_tpu.models.gemma3 import GEMMA3_1B, GEMMA3_4B, GEMMA3_270M
    from onnx_quantize_tpu.ops.dispatch import select_path
    from onnx_quantize_tpu.ops.kernels.matmul_w4 import w4_dequant_matmul
    from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp

    log(f"[kernels] W4 g128 kernel vs the jnp oracle as XLA compiles it; "
        f"times are per call on {card}")
    key = jax.random.key(0)
    for name, cfg in (("270m", GEMMA3_270M), ("1b", GEMMA3_1B), ("4b", GEMMA3_4B)):
        full = name == "1b"
        for site, (K, N) in site_shapes(cfg).items():
            key, kq, kx = jax.random.split(key, 3)
            qt = random_w4(kq, K, N, 128)
            paths = " ".join(
                f"M={M}:{select_path((M,), qt, backend='gpu', impl='auto')}"
                f"/{select_path((M, 1), qt, backend='gpu', impl='auto')}"
                for M in SWEEP_M)
            log(f"[kernels] {name}/{site} K={K} N={N} dispatch (2d/decode) {paths}")
            if full:
                x32 = jax.random.normal(kx, (8, K), jnp.float32)
                with jax.default_matmul_precision("highest"):
                    ref = quantized_matmul_jnp(x32, qt)
                err = rel_err(w4_dequant_matmul(x32, qt), ref)
                expect(err <= F32_TOL,
                       f"{name}/{site} f32 kernel err {err} > {F32_TOL}")
                log(f"[kernels] {name}/{site} f32 M=8 err={err:.2e} (tol {F32_TOL})")
            for M in SWEEP_M if full else (32,):
                if site == "lm_head" and M > 64:
                    continue  # the engine projects only each row's last token
                x = jax.random.normal(kx, (M, K), jnp.bfloat16)
                reps = 3 if M == PREFILL_M else 20
                t_k, y_k = time_chain(
                    lambda a, q: w4_dequant_matmul(a, q), x, qt, reps)
                t_p, y_p = time_chain(
                    lambda a, q: quantized_matmul_jnp(a, q), x, qt, reps)
                err = rel_err(y_k, y_p)
                expect(err <= BF16_TOL,
                       f"{name}/{site} M={M} bf16 kernel err {err} > {BF16_TOL}")
                extra = ""
                if M == 32 and full:
                    t_f, y_f = time_chain(folded_w4_jnp, x, qt, reps)
                    expect(rel_err(y_f, y_p) <= BF16_TOL, "folded jnp diverges")
                    extra = f" folded_jnp_us={t_f * 1e6:.2f}"
                log(f"[kernels] {name}/{site} M={M} kernel_us={t_k * 1e6:.2f} "
                    f"xla_oracle_us={t_p * 1e6:.2f}{extra} err={err:.2e} "
                    f"(tol {BF16_TOL})")


def phase_gpu_tests():
    import pytest

    os.environ["OQT_TESTS_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/ops/test_kernels_gpu.py"])
    expect(rc == 0, f"gpu-marked tests failed (pytest rc {rc})")
    log("[gpu-tests] ok")


@dataclasses.dataclass
class ArmResult:
    decode_tok_s: float
    model: object
    params: dict


def _reference_last_logits(model_cfg, params, ids):
    """f32 forward of ``params`` (quantized leaves kept, float leaves cast to
    f32) on the jnp oracle at highest matmul precision; last-token logits."""
    import jax
    import jax.numpy as jnp

    from onnx_quantize_tpu import nn, ops
    from onnx_quantize_tpu.models.gemma3 import Gemma3

    ref_model = Gemma3(dataclasses.replace(model_cfg, dtype="float32"))
    p32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if isinstance(a, jax.Array) and jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        params, is_leaf=lambda a: isinstance(a, nn.QTensor),
    )
    ops.set_impl("jnp")
    try:
        with jax.default_matmul_precision("highest"):
            @jax.jit
            def fwd(p, ids):
                h = ref_model.hidden_states(p, ids)[:, -1:]
                return ref_model.lm_head(p["lm_head"], h)[:, 0]

            return fwd(p32, jnp.asarray(ids))
    finally:
        ops.set_impl("auto")


def run_arm(label, cfg, quantized, dev, card, rng) -> ArmResult:
    import jax
    import jax.numpy as jnp

    from bench import build_arm
    from onnx_quantize_tpu.engine import ContinuousBatchingScheduler, InferenceEngine

    B, T, steps, max_seq = 32, 512, 32, 1024
    t0 = time.perf_counter()
    model, params = build_arm(cfg, quantized=quantized, init_device=dev)
    jax.block_until_ready(params)
    log(f"[main:{label}] quantize+fuse {time.perf_counter() - t0:.1f}s")
    engine = InferenceEngine(model, params, max_batch=B, max_seq=max_seq,
                             kv_quant=quantized, dtype=jnp.bfloat16)
    ids = rng.integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    lengths = np.full((B,), T, np.int32)

    t0 = time.perf_counter()
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    jax.block_until_ready(logits)
    log(f"[main:{label}] prefill compile+run {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    jax.block_until_ready(logits)
    prefill_s = time.perf_counter() - t0
    expect(logits.shape == (B, cfg.vocab_size), f"prefill logits {logits.shape}")
    expect(bool(jnp.all(jnp.isfinite(logits))), "prefill logits not finite")

    ref = _reference_last_logits(cfg, engine.params, ids[:4])
    err = rel_err(logits[:4], ref)
    agree = float(np.mean(np.argmax(np.asarray(logits[:4], np.float32), -1)
                          == np.argmax(np.asarray(ref), -1)))
    log(f"[main:{label}] prefill logits vs f32 reference: err={err:.2e} "
        f"(tol {ENGINE_BF16_TOL}) top1_agree={agree:.2f}")
    expect(err <= ENGINE_BF16_TOL, f"{label} prefill logits err {err}")

    first = np.asarray(jnp.argmax(logits, -1), np.int32)
    cache, gen = engine.decode_multi(cache, first, steps=steps)
    gen = np.asarray(gen)
    expect(gen.shape == (B, steps), f"decode shape {gen.shape}")
    expect(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()), "token ids out of range")
    decode_tok_s = decode_tok_s_of(engine, ids, lengths, first, steps)

    # Prompts of 8..64 tokens share one padded admission width, so the
    # scheduler compiles few serve variants.
    sched = ContinuousBatchingScheduler(engine, chunk=8, pipeline=2)
    srng = np.random.default_rng(5)
    reqs = []
    for _ in range(16):
        plen = int(srng.integers(8, 65))
        reqs.append(sched.submit(
            list(srng.integers(1, cfg.vocab_size, size=plen)),
            max_new_tokens=int(srng.integers(4, 48)),
        ))
    t0 = time.perf_counter()
    sched.run()
    serve_s = time.perf_counter() - t0
    for r in reqs:
        expect(len(r.output) == r.max_new_tokens,
               f"request {r.request_id}: {len(r.output)} of {r.max_new_tokens}")
    served = sum(len(r.output) for r in reqs)
    log(f"[main:{label}] prefill B={B} T={T}: {prefill_s * 1e3:.1f} ms; "
        f"decode_multi B={B} steps={steps}: {decode_tok_s:.1f} tok/s; "
        f"scheduler: 16 requests, {served} tokens in {serve_s:.2f} s "
        f"(incl. compile); peak_bytes_in_use={peak_bytes(dev)} on {card}")
    return ArmResult(decode_tok_s, model, params)


def decode_tok_s_of(engine, ids, lengths, first, steps) -> float:
    """Tokens/s of a warm ``decode_multi`` of ``steps`` steps after a fresh
    prefill, median of 3 (the first call compiles and is not timed)."""
    import jax

    times = []
    for i in range(4):
        cache, _ = engine.prefill(engine.new_cache(), ids, lengths)
        jax.block_until_ready(cache)
        t0 = time.perf_counter()
        cache, gen = engine.decode_multi(cache, first, steps=steps)
        jax.block_until_ready(gen)
        if i:
            times.append(time.perf_counter() - t0)
    return ids.shape[0] * steps / float(np.median(times))


def _decode_tok_s_with(matmul, model, params, rng) -> float:
    """Decode tok/s (B = 32) of a W4 model with ``ops.quantized_matmul``
    replaced by ``matmul`` for the engine's trace (the plain formulations the
    kernel is measured against)."""
    import jax.numpy as jnp

    from onnx_quantize_tpu import ops
    from onnx_quantize_tpu.engine import InferenceEngine

    B, T, steps = 32, 512, 32
    vocab = model.cfg.vocab_size
    ids = rng.integers(1, vocab, size=(B, T)).astype(np.int32)
    lengths = np.full((B,), T, np.int32)
    first = rng.integers(1, vocab, size=(B,)).astype(np.int32)
    orig = ops.quantized_matmul
    ops.quantized_matmul = matmul
    try:
        engine = InferenceEngine(model, params, max_batch=B,
                                 max_seq=1024, kv_quant=True,
                                 dtype=jnp.bfloat16)
        return decode_tok_s_of(engine, ids, lengths, first, steps)
    finally:
        ops.quantized_matmul = orig


def phase_main_path(dev, card):
    import jax
    import jax.numpy as jnp

    from bench import build_arm
    from onnx_quantize_tpu import ops
    from onnx_quantize_tpu.engine import InferenceEngine
    from onnx_quantize_tpu.models.gemma3 import GEMMA3_1B, GEMMA3_270M
    from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp

    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(GEMMA3_1B, dtype="bfloat16")
    w4 = run_arm("w4", cfg, True, dev, card, rng)
    bf16 = run_arm("bf16", cfg, False, dev, card, rng)
    log(f"[main] Gemma-3-1B decode B=32 tok/s on {card}: "
        f"w4_arm={w4.decode_tok_s:.1f} bf16_arm={bf16.decode_tok_s:.1f}")

    # The kernel against the two plain versions, end to end (decode scan).
    def folded(x, qt, bias=None):
        if qt.meta.packed and qt.meta.strat.value == "group" \
                and bias is None and qt.meta.input_quant.mode == "none":
            return folded_w4_jnp(x, qt)
        return quantized_matmul_jnp(x, qt, bias)

    tok_s = {
        name: _decode_tok_s_with(fn, w4.model, w4.params, rng)
        for name, fn in (("w4_xla_oracle", quantized_matmul_jnp),
                         ("w4_folded_jnp", folded))
    }
    log(f"[main] Gemma-3-1B W4 decode B=32 tok/s on {card}: w4_dispatch="
        f"{w4.decode_tok_s:.1f} (the W4 arm above) "
        + " ".join(f"{k}={v:.1f}" for k, v in tok_s.items())
        + " (same params)")
    del w4, bf16

    # 270M: its small sites fill the card least (published widths, 18 layers).
    model, params = build_arm(dataclasses.replace(GEMMA3_270M, dtype="bfloat16"),
                              quantized=True, init_device=dev)
    tok_s = {
        name: _decode_tok_s_with(fn, model, params, rng)
        for name, fn in (("w4_xla_oracle", quantized_matmul_jnp),
                         ("w4_dispatch", ops.quantized_matmul))
    }
    log(f"[main] Gemma-3-270M W4 decode B=32 tok/s on {card}: "
        + " ".join(f"{k}={v:.1f}" for k, v in tok_s.items()))
    del model, params

    # f32 engine on the GPU's chosen path vs the jnp path (depth cut to 2
    # layers, published widths; prefill at 32 rows takes the kernel too). No
    # KV quantization: this compares the matmul paths, not KV rounding.
    cfg32 = dataclasses.replace(GEMMA3_1B, num_layers=2)
    model, params = build_arm(cfg32, quantized=True, init_device=dev)
    ids = rng.integers(1, cfg32.vocab_size, size=(4, 8)).astype(np.int32)
    lengths = np.full((4,), 8, np.int32)
    out = {}
    for impl in ("auto", "jnp"):
        ops.set_impl(impl)
        try:
            with jax.default_matmul_precision("highest"):
                engine = InferenceEngine(model, params, max_batch=4, max_seq=64,
                                         kv_quant=False, dtype=jnp.float32)
                cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
                first = np.asarray(jnp.argmax(logits, -1), np.int32)
                cache, step_logits = engine.decode(cache, first)
                out[impl] = (np.asarray(logits), np.asarray(step_logits))
        finally:
            ops.set_impl("auto")
    e_pre = rel_err(out["auto"][0], out["jnp"][0])
    e_dec = rel_err(out["auto"][1], out["jnp"][1])
    log(f"[main] f32 engine, chosen GPU path vs jnp path: prefill err="
        f"{e_pre:.2e} decode err={e_dec:.2e} (tol {F32_TOL})")
    expect(e_pre <= F32_TOL and e_dec <= F32_TOL, "f32 engine paths diverge")


def phase_calibration(dev):
    import jax

    import onnx_quantize_tpu as oqt
    from onnx_quantize_tpu.calibration import calibrate
    from onnx_quantize_tpu.models.gemma3 import GEMMA3_270M, Gemma3

    resolved = []
    orig = calibrate._resolve_backend

    def recording(backend):
        platform = orig(backend)
        resolved.append(platform)
        return platform

    # Published widths, depth cut to 6 layers (one local:global period).
    cfg = dataclasses.replace(GEMMA3_270M, num_layers=6)
    model = Gemma3(cfg)
    params = model.init(jax.random.key(3))
    calib = np.random.default_rng(3).integers(
        1, GEMMA3_270M.vocab_size, size=(8, 64)).astype(np.int32)
    qconfig = oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", strategy="channel", symmetric=True),
        input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
        preprocessors=[oqt.SmoothQuantConfig(alpha=0.5)],
        ignore=["lm_head"],
        calibration_data=calib,
        calibration_params=oqt.CalibrationParams(
            num_samples=8, batch_size=4, backend="default"),
    )
    calibrate._resolve_backend = recording
    try:
        t0 = time.perf_counter()
        qparams, _ = oqt.quantize(model, params, qconfig)
        secs = time.perf_counter() - t0
    finally:
        calibrate._resolve_backend = orig
    expect(bool(resolved) and all(p == "gpu" for p in resolved),
           f"calibration forwards ran on {resolved}, not the GPU")
    y = np.asarray(model(qparams, calib[:2]))
    expect(bool(np.isfinite(y).all()), "W8A8 logits not finite")
    log(f"[calibration] static W8A8 + SmoothQuant at Gemma-3-270M widths "
        f"(6 layers): "
        f"{len(resolved)} calibration pass(es) on {resolved[0]}, quantize "
        f"{secs:.1f}s, logits finite; peak_bytes_in_use={peak_bytes(dev)}")


def _moe_prefill(model, params, ids, ragged, dtype, kv_quant, timed):
    """Last-token prefill logits of a fresh engine with the MoE prefill path
    forced to ragged_dot (True) or dense-masked (False); and the median warm
    time of 3 prefills when ``timed``."""
    import jax

    from onnx_quantize_tpu.engine import InferenceEngine

    B, T = ids.shape
    lengths = np.full((B,), T, np.int32)
    for block in model.blocks:
        block.mlp.use_ragged_prefill = ragged
    try:
        engine = InferenceEngine(model, params, max_batch=B, max_seq=T,
                                 kv_quant=kv_quant, dtype=dtype)
        cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
        jax.block_until_ready(logits)
        times = []
        for _ in range(3 if timed else 0):
            t0 = time.perf_counter()
            cache, logits = engine.prefill(cache, ids, lengths)
            jax.block_until_ready(logits)
            times.append(time.perf_counter() - t0)
    finally:
        for block in model.blocks:
            block.mlp.use_ragged_prefill = "auto"
    return logits, float(np.median(times)) if times else None


def phase_moe(dev, card):
    """Fused-expert MoE prefill through ``lax.ragged_dot`` and dense-masked.

    Correctness in f32 (a bf16 run can flip a near-tied top-2 routing
    between two formulations and diverge from there): each path against the
    f32 forward of the same quantized params. Speed in bf16 at a bulk
    prefill M: the reading behind auto mode's dense-masked choice."""
    import jax
    import jax.numpy as jnp

    from bench import MOE_CONFIG, build_arm
    from onnx_quantize_tpu.models.gemma3 import Gemma3
    from onnx_quantize_tpu.models.moe import moe_config

    # Published widths of the bench config, depth cut to 4 layers.
    cfg = dataclasses.replace(moe_config(**MOE_CONFIG), num_layers=4)
    model, params = build_arm(cfg, quantized=True, init_device=dev)
    expect("_fused_experts" in params["layers.0"]["mlp"],
           "MoE experts not in the fused engine layout")
    rng = np.random.default_rng(4)

    ids = rng.integers(1, cfg.vocab_size, size=(4, 512)).astype(np.int32)
    ref = _reference_last_logits(cfg, params, ids)
    errs = {}
    with jax.default_matmul_precision("highest"):
        for ragged in (True, False):
            logits, _ = _moe_prefill(model, params, ids, ragged, jnp.float32,
                                     False, timed=False)
            errs[ragged] = rel_err(logits, ref)
    log(f"[moe] f32 prefill M={ids.size} vs the f32 forward: ragged_dot "
        f"err={errs[True]:.2e}, dense-masked err={errs[False]:.2e} "
        f"(tol {MOE_F32_TOL})")
    expect(errs[False] <= MOE_F32_TOL, f"MoE dense-masked prefill err {errs[False]}")

    bmodel = Gemma3(dataclasses.replace(cfg, dtype="bfloat16"))
    bparams = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16)
        if isinstance(a, jax.Array) and a.dtype == jnp.float32 else a,
        params, is_leaf=lambda a: hasattr(a, "meta"))
    ids = rng.integers(1, cfg.vocab_size, size=(16, 512)).astype(np.int32)
    out = {r: _moe_prefill(bmodel, bparams, ids, r, jnp.bfloat16, True, True)
           for r in (True, False)}
    log(f"[moe] bf16 prefill M={ids.size}: ragged_dot {out[True][1] * 1e3:.1f} ms, "
        f"dense-masked {out[False][1] * 1e3:.1f} ms, ragged vs dense "
        f"err={rel_err(out[True][0], out[False][0]):.2e} on {card}")


# ── four cards ───────────────────────────────────────────────────────────


def phase_four(card):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    import onnx_quantize_tpu as oqt
    from bench import MOE_CONFIG, build_arm
    from onnx_quantize_tpu.engine import ContinuousBatchingScheduler, InferenceEngine
    from onnx_quantize_tpu.models.gemma3 import GEMMA3_4B, Gemma3, fuse_gemma3_projections
    from onnx_quantize_tpu.models.moe import moe_config, stack_moe_experts
    from onnx_quantize_tpu.parallel import make_mesh

    devs = jax.devices()
    expect(len(devs) == 4, f"--four needs 4 GPUs, JAX found {len(devs)}")
    mesh = make_mesh(model_parallel=4, devices=devs)
    t0 = time.perf_counter()

    def serve(label, engine, ids, lengths):
        """Prefill, a 4-step ``decode_multi``, and a scheduler run of one
        request per row (equal prompt lengths: one admission width)."""
        cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
        first = np.asarray(jnp.argmax(logits, -1), np.int32)
        cache, gen = engine.decode_multi(cache, first, steps=4)
        sched = ContinuousBatchingScheduler(engine, chunk=2, pipeline=2)
        reqs = [sched.submit(list(ids[i, :8]), max_new_tokens=3)
                for i in range(ids.shape[0])]
        sched.run()
        log(f"[four] {label} served at {time.perf_counter() - t0:.1f}s")
        return np.asarray(logits), np.asarray(gen), [r.output for r in reqs]

    with jax.default_matmul_precision("highest"):
        # TP = 4 at Gemma-3-4B published widths (8 heads, 4 KV heads: one per
        # card), depth cut to 2 layers, f32 so greedy tokens are stable.
        cfg = dataclasses.replace(GEMMA3_4B, num_layers=2)
        model, params = build_arm(cfg, quantized=True, init_device=devs[0],
                                  head="w4")
        log(f"[four] 4B-width W4 params built at {time.perf_counter() - t0:.1f}s")
        rng = np.random.default_rng(8)
        ids = rng.integers(1, cfg.vocab_size, size=(4, 16)).astype(np.int32)
        lengths = np.full((4,), 16, np.int32)
        one = serve("tp: one card", InferenceEngine(
            model, params, max_batch=4, max_seq=64, kv_quant=True), ids, lengths)
        tp = serve("tp: TP=4", InferenceEngine(
            model, params, max_batch=4, max_seq=64, kv_quant=True, mesh=mesh),
            ids, lengths)
        err = rel_err(tp[0], one[0])
        expect(err <= SHARD_TOL, f"TP logits err {err}")
        expect((tp[1] == one[1]).all(), "TP greedy tokens differ")
        expect(tp[2] == one[2], "TP scheduler outputs differ")
        log(f"[four:tp] Gemma-3-4B widths (2 layers) TP=4 vs one card: logits "
            f"err={err:.2e} (tol {SHARD_TOL}), greedy decode + scheduler tokens equal")

        # EP: the bench MoE config (8 x 2816, top-2; depth cut to 2 layers),
        # stacked experts sharded two per card.
        mcfg = dataclasses.replace(moe_config(**MOE_CONFIG), num_layers=2)
        mmodel = Gemma3(mcfg)
        mparams = mmodel.init(jax.random.key(7))
        mq, _ = oqt.quantize(mmodel, mparams, oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=128),
            ignore=[r"\.router$"]))
        stacked = stack_moe_experts(fuse_gemma3_projections(mq))
        ids = rng.integers(1, mcfg.vocab_size, size=(4, 16)).astype(np.int32)
        one = serve("ep: one card", InferenceEngine(
            mmodel, stacked, max_batch=4, max_seq=64, kv_quant=True), ids, lengths)
        ep = serve("ep: EP over 4", InferenceEngine(
            mmodel, stacked, max_batch=4, max_seq=64, kv_quant=True, mesh=mesh),
            ids, lengths)
        err = rel_err(ep[0], one[0])
        expect(err <= SHARD_TOL, f"EP logits err {err}")
        expect((ep[1] == one[1]).all(), "EP greedy tokens differ")
        expect(ep[2] == one[2], "EP scheduler outputs differ")
        log(f"[four:ep] MoE 8x2816 top-2 (2 layers) EP over 4 cards vs one: "
            f"logits err={err:.2e} (tol {SHARD_TOL}), greedy tokens equal")

        graft._dryrun_pp(4)
        log(f"[four:pp] __graft_entry__ PP leg (4 stages) ok at "
            f"{time.perf_counter() - t0:.1f}s")
        graft._dryrun_cp(4)
        log(f"[four:cp] __graft_entry__ CP leg (4 shards, + 2x2 seq x model) ok "
            f"at {time.perf_counter() - t0:.1f}s")
    for d in devs:
        log(f"[four] {d} peak_bytes_in_use={peak_bytes(d)} on {card}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU TP, EP, PP and CP legs")
    args = parser.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from onnx_quantize_tpu.utils.compile_cache import enable_compile_cache
    from onnx_quantize_tpu.utils.device import (
        card_name_and_power_limit,
        device_record,
        require_gpu,
    )

    dev = require_gpu()
    enable_compile_cache()
    import jax

    from onnx_quantize_tpu import native

    card = card_name_and_power_limit().replace("\n", "; ")
    log(f"[device] {dev.device_kind} x{len(jax.devices())}; card: {card}")
    loaded = native.get_lib() is not None
    log(f"[device] native host library loaded: {loaded}"
        + ("" if loaded else f" ({native.build_error() or 'disabled'})"))
    t0 = time.perf_counter()
    if args.four:
        phase_four(card)
    else:
        for name, phase in (
            ("kernels", lambda: phase_kernels(card)),
            ("gpu-tests", phase_gpu_tests),
            ("main", lambda: phase_main_path(dev, card)),
            ("calibration", lambda: phase_calibration(dev)),
            ("moe", lambda: phase_moe(dev, card)),
        ):
            t = time.perf_counter()
            phase()
            log(f"[{name}] phase done in {time.perf_counter() - t:.1f}s")
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": device_record()}))


if __name__ == "__main__":
    main()

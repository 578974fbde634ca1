"""Serve-mode (chunk > 1) rounds: ONE device program per round with per-slot
sampling, EOS, and budgets.

The chunked scheduler must handle heterogeneous SamplingParams and
per-request EOS inside a single program, with greedy rows bit-equal to the
per-step reference loop, and enforce submit-time validation instead of
silently truncating."""

import numpy as np
import pytest

import jax

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.engine import ContinuousBatchingScheduler, InferenceEngine
from onnx_quantize_tpu.engine.sampling import (
    SamplingParams,
    batch_sampling_arrays,
    sample,
    sample_batch,
)
from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config


@pytest.fixture(scope="module")
def quantized_model():
    cfg = Gemma3Config.tiny(
        hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
        num_kv_heads=1, head_dim=32, vocab_size=128,
    )
    model = Gemma3(cfg)
    params = model.init(jax.random.key(0))
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16)))
    return model, qparams


def _engine(model, params, max_seq=48, max_batch=2):
    return InferenceEngine(model, params, max_batch=max_batch, max_seq=max_seq,
                           kv_quant=True)


# ── vectorized sampler == scalar sampler ─────────────────────────────────


@pytest.mark.parametrize("params", [
    SamplingParams(),
    SamplingParams(temperature=0.7),
    SamplingParams(temperature=0.7, top_k=5),
    SamplingParams(temperature=1.3, top_p=0.8),
    SamplingParams(temperature=0.9, top_k=12, top_p=0.6),
])
def test_sample_batch_matches_scalar(params):
    """Uniform per-row arrays must reproduce the scalar sampler exactly
    (same rng, same masks, same categorical draw)."""
    rng = jax.random.key(42)
    logits = jax.random.normal(jax.random.key(1), (6, 64)) * 3.0
    expected = np.asarray(sample(logits, rng, params))
    arrays, variant = batch_sampling_arrays([params] * 6)
    got = np.asarray(sample_batch(
        logits, rng, *map(np.asarray, arrays),
        need_temp=variant[0], need_topk=variant[1], need_topp=variant[2],
    ))
    np.testing.assert_array_equal(got, expected)


def test_sample_batch_mixed_rows_greedy_exact():
    """Greedy rows in a mixed batch must equal argmax regardless of what the
    sampled rows do; disabled features must be per-row no-ops."""
    logits = jax.random.normal(jax.random.key(2), (4, 64)) * 3.0
    plist = [
        SamplingParams(),                                   # greedy
        SamplingParams(temperature=0.8, top_k=4),
        SamplingParams(),                                   # greedy
        SamplingParams(temperature=1.1, top_p=0.7),
    ]
    arrays, variant = batch_sampling_arrays(plist)
    assert variant == (True, True, True)
    toks = np.asarray(sample_batch(
        logits, jax.random.key(3), *map(np.asarray, arrays),
        need_temp=True, need_topk=True, need_topp=True,
    ))
    greedy = np.asarray(np.argmax(np.asarray(logits), axis=-1))
    assert toks[0] == greedy[0] and toks[2] == greedy[2]
    assert all(0 <= t < 64 for t in toks)


def test_sample_batch_topk_restricts_support():
    """Sampled tokens must come from each row's own top-k set."""
    logits = jax.random.normal(jax.random.key(4), (3, 64)) * 5.0
    arrays = (
        np.array([1.0, 1.0, 1.0], np.float32),
        np.array([1, 3, 0], np.int32),  # row 2: disabled
        np.ones((3,), np.float32),
    )
    l = np.asarray(logits)
    for seed in range(8):
        toks = np.asarray(sample_batch(
            logits, jax.random.key(seed), *arrays,
            need_temp=True, need_topk=True, need_topp=False,
        ))
        assert toks[0] == np.argmax(l[0])
        assert toks[1] in np.argsort(l[1])[-3:]


# ── scheduler: heterogeneous requests in one program ─────────────────────


def _run(model, params, chunk, reqs, max_seq=48, pipeline=1, max_batch=2):
    engine = _engine(model, params, max_seq=max_seq, max_batch=max_batch)
    sched = ContinuousBatchingScheduler(engine, chunk=chunk, pipeline=pipeline)
    handles = [sched.submit(p, **kw) for p, kw in reqs]
    sched.run()
    assert all(r.done for r in handles)
    return [r.output for r in handles]


def test_mixed_eos_matches_per_step(quantized_model):
    """Different EOS ids per request (one with none) — greedy, so chunked
    serve mode must match the per-step loop token-for-token. Regression: the
    old chunked path applied the first slot's EOS to the whole batch."""
    model, qparams = quantized_model
    # Discover what the model emits for each prompt to build effective EOS.
    probe = _run(model, qparams, 1, [
        ([5, 9, 17], dict(max_new_tokens=6)),
        ([3, 2, 77, 8], dict(max_new_tokens=6)),
    ])
    eos_a = probe[0][2]  # request A stops at its 3rd token
    reqs = [
        ([5, 9, 17], dict(max_new_tokens=10, eos_token_id=eos_a)),
        ([3, 2, 77, 8], dict(max_new_tokens=7, eos_token_id=None)),
        ([11, 4], dict(max_new_tokens=5, eos_token_id=int(probe[1][0]) + 1)),
    ]
    base = _run(model, qparams, 1, reqs)
    chunked = _run(model, qparams, 8, reqs)
    assert chunked == base
    assert base[0][-1] == eos_a and len(base[0]) <= 4
    assert len(base[1]) == 7


def test_mixed_sampling_single_round(quantized_model):
    """A greedy request and a sampled request share one serve round: the
    greedy row must match the all-greedy per-step run exactly; the sampled
    row must be valid and respect its budget."""
    model, qparams = quantized_model
    greedy_ref = _run(model, qparams, 1, [
        ([5, 9, 17], dict(max_new_tokens=8)),
    ])[0]
    outs = _run(model, qparams, 8, [
        ([5, 9, 17], dict(max_new_tokens=8)),
        ([3, 2, 77], dict(max_new_tokens=6,
                          sampling=SamplingParams(temperature=0.9, top_k=16))),
    ])
    assert outs[0] == greedy_ref
    assert 1 <= len(outs[1]) <= 6 and all(0 <= t < 128 for t in outs[1])


def test_serve_deterministic_under_sampling(quantized_model):
    """Same scheduler seed => identical sampled outputs (rng is split per
    round and per step inside the program)."""
    model, qparams = quantized_model
    reqs = [
        ([5, 9, 17], dict(max_new_tokens=7,
                          sampling=SamplingParams(temperature=0.8))),
        ([3, 2], dict(max_new_tokens=5,
                      sampling=SamplingParams(temperature=1.2, top_p=0.9))),
    ]
    a = _run(model, qparams, 4, reqs)
    b = _run(model, qparams, 4, reqs)
    assert a == b


def test_serve_capacity_freeze_matches(quantized_model):
    """Cache capacity mid-chunk: serve mode freezes the slot in-program and
    must match the per-step loop."""
    model, qparams = quantized_model
    reqs = [([1, 2, 3, 4], dict(max_new_tokens=64))]
    base = _run(model, qparams, 1, reqs, max_seq=12)
    chunked = _run(model, qparams, 8, reqs, max_seq=12)
    assert chunked == base


def test_serve_budget_freezes_kv(quantized_model):
    """Slots stop advancing device lengths once their budget is exhausted
    (the old chunked path kept writing surplus KV past max_new)."""
    model, qparams = quantized_model
    engine = _engine(model, qparams, max_seq=48)
    sched = ContinuousBatchingScheduler(engine, chunk=8)
    sched.submit([5, 9, 17], max_new_tokens=3)
    sched.run()
    # prompt(3) + decode-consumed tokens: t0 and token2 write KV; the 3rd
    # emission's input is never consumed. lengths = 3 + 2.
    assert int(np.asarray(sched.cache["lengths"])[0]) == 5


def test_submit_rejects_oversized_prompt(quantized_model):
    model, qparams = quantized_model
    engine = _engine(model, qparams, max_seq=16)
    sched = ContinuousBatchingScheduler(engine, chunk=4)
    with pytest.raises(ValueError, match="max_seq"):
        sched.submit(list(range(1, 20)))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit([1, 2, 3], max_new_tokens=0)


def test_full_length_prompt_emits_one_token(quantized_model):
    """A prompt that exactly fills the cache gets its prefill token and
    finishes immediately — identically in both modes."""
    model, qparams = quantized_model
    prompt = list(range(1, 13))
    base = _run(model, qparams, 1, [(prompt, dict(max_new_tokens=4))], max_seq=12)
    chunked = _run(model, qparams, 4, [(prompt, dict(max_new_tokens=4))], max_seq=12)
    assert base == chunked
    assert len(base[0]) == 1


# ── pipelined rounds (device-resident carry) ─────────────────────────────


def test_pipelined_rounds_match_unpipelined(quantized_model):
    """pipeline > 1 dispatches continuation rounds from the device carry
    before any blob fetch; outputs must equal the unpipelined serve mode and
    the per-step loop exactly (greedy + per-request EOS + budgets)."""
    model, qparams = quantized_model
    probe = _run(model, qparams, 1, [
        ([5, 9, 17], dict(max_new_tokens=12)),
        ([3, 2, 77, 8], dict(max_new_tokens=12)),
    ])
    reqs = [
        ([5, 9, 17], dict(max_new_tokens=12, eos_token_id=probe[0][5])),
        ([3, 2, 77, 8], dict(max_new_tokens=9, eos_token_id=None)),
    ]
    base = _run(model, qparams, 1, reqs)
    for pipeline in (2, 4):
        got = _run(model, qparams, 4, reqs, pipeline=pipeline)
        assert got == base, pipeline


def test_pipelined_sampling_deterministic(quantized_model):
    """Sampled outputs under pipelining are reproducible for a fixed seed
    and stay within budget/vocab."""
    model, qparams = quantized_model
    reqs = [
        ([5, 9, 17], dict(max_new_tokens=10,
                          sampling=SamplingParams(temperature=0.8, top_k=12))),
        ([3, 2, 77], dict(max_new_tokens=7)),
    ]
    a = _run(model, qparams, 4, reqs, pipeline=3)
    b = _run(model, qparams, 4, reqs, pipeline=3)
    assert a == b
    assert len(a[0]) <= 10 and all(0 <= t < 128 for t in a[0])
    # The greedy row is indifferent to its neighbor's sampling and to the
    # round grouping.
    greedy_ref = _run(model, qparams, 1, [reqs[1]])
    assert a[1] == greedy_ref[0]


def test_pipelined_continuous_load_all_complete(quantized_model):
    """More requests than slots: admissions at group boundaries, frozen
    slots wait for the group tail — every request still completes with the
    same greedy outputs as the per-step loop."""
    model, qparams = quantized_model
    rng = np.random.default_rng(3)
    reqs = [
        (list(rng.integers(1, 128, size=int(rng.integers(2, 8)))),
         dict(max_new_tokens=int(rng.integers(3, 12))))
        for _ in range(7)
    ]
    base = _run(model, qparams, 1, reqs, max_batch=2)
    got = _run(model, qparams, 4, reqs, pipeline=3, max_batch=2)
    assert got == base


# ── narrow admission (rows-only prefill) ─────────────────────────────────


class TestNarrowAdmission:
    # Staggered budgets over more requests than slots: completions free
    # SMALL slot groups at different rounds, so steady-state admissions fall
    # under the narrow gate (len(admitted) <= max_batch // 2).
    BUDGETS = (3, 9, 5, 12, 4, 8, 6, 10, 7, 5, 11, 4)

    def _outputs(self, model, params, *, narrow, kv_quant=True, temp=0.0,
                 chunk=2, pipeline=2):
        rng = np.random.default_rng(3)
        prompts = [list(rng.integers(1, 128, size=int(rng.integers(2, 10))))
                   for _ in self.BUDGETS]
        engine = InferenceEngine(model, params, max_batch=8, max_seq=64,
                                 kv_quant=kv_quant)
        sched = ContinuousBatchingScheduler(engine, chunk=chunk,
                                            pipeline=pipeline)
        sched.narrow_admit = narrow
        narrow_calls = []
        orig = sched._build_admit_narrow
        sched._build_admit_narrow = (
            lambda admitted: (narrow_calls.append(len(admitted)), orig(admitted))[1]
        )
        sp = SamplingParams(temperature=temp, top_k=8 if temp > 0 else 0)
        reqs = [sched.submit(p, max_new_tokens=m, sampling=sp)
                for p, m in zip(prompts, self.BUDGETS)]
        sched.run()
        return [r.output for r in reqs], narrow_calls

    @pytest.mark.parametrize("kv_quant", [True, False])
    def test_matches_full_admission_and_oracle(self, quantized_model, kv_quant):
        """Rows-only admission must be BIT-identical to the full masked
        prefill (it attends over the same int8/fp values through the same
        code path) — and therefore to the per-step oracle. The workload must
        actually EXERCISE the narrow path (staggered frees; asserted)."""
        model, qparams = quantized_model
        narrow, calls = self._outputs(model, qparams, narrow=True,
                                      kv_quant=kv_quant)
        assert calls, "workload never hit the narrow-admission gate"
        full, no_calls = self._outputs(model, qparams, narrow=False,
                                       kv_quant=kv_quant)
        assert not no_calls
        oracle, _ = self._outputs(model, qparams, narrow=False,
                                  kv_quant=kv_quant, chunk=1, pipeline=1)
        assert narrow == full == oracle

    def test_matches_under_sampling(self, quantized_model):
        """Sampled admissions scatter their logits into the full batch rows
        before sampling (categorical noise is positional), so sampled tokens
        match the masked path bit-for-bit too."""
        model, qparams = quantized_model
        narrow, calls = self._outputs(model, qparams, narrow=True, temp=0.8)
        assert calls, "workload never hit the narrow-admission gate"
        full, _ = self._outputs(model, qparams, narrow=False, temp=0.8)
        assert narrow == full

    def test_admit_prefill_impl_bit_parity(self, quantized_model):
        """Unit tier: _admit_prefill_impl's logits and written cache rows
        equal the full masked _prefill_impl's for the same admissions."""
        model, qparams = quantized_model
        engine = _engine(model, qparams, max_batch=4)
        rng = np.random.default_rng(0)
        B, T = 4, 8
        ids_full = np.zeros((B, T), np.int32)
        lengths_full = np.ones((B,), np.int32)
        mask = np.array([False, True, False, True])
        prompts = {1: list(rng.integers(1, 128, size=5)),
                   3: list(rng.integers(1, 128, size=8))}
        for s, p in prompts.items():
            ids_full[s, : len(p)] = p
            lengths_full[s] = len(p)

        import jax.numpy as jnp

        cache0 = engine.new_cache()
        cache_f, logits_f, greedy_f = jax.jit(engine._prefill_impl)(
            engine.params, cache0, jnp.asarray(ids_full),
            jnp.asarray(lengths_full), jnp.asarray(mask),
        )

        ids_n = np.stack([ids_full[1], ids_full[3]])
        lengths_n = np.array([5, 8], np.int32)
        slots = np.array([1, 3], np.int32)
        cache_n, logits_n, greedy_n = jax.jit(engine._admit_prefill_impl)(
            engine.params, engine.new_cache(), jnp.asarray(ids_n),
            jnp.asarray(lengths_n), jnp.asarray(slots),
        )
        np.testing.assert_array_equal(
            np.asarray(logits_n), np.asarray(logits_f)[[1, 3]]
        )
        np.testing.assert_array_equal(
            np.asarray(greedy_n), np.asarray(greedy_f)[[1, 3]]
        )
        for key in ("k", "v", "k_scale", "v_scale"):
            for slot, ln in ((1, 5), (3, 8)):
                np.testing.assert_array_equal(
                    np.asarray(cache_n[key][:, slot, :ln]),
                    np.asarray(cache_f[key][:, slot, :ln]),
                    err_msg=f"{key} slot {slot}",
                )
        np.testing.assert_array_equal(
            np.asarray(cache_n["lengths"])[[1, 3]], [5, 8]
        )

    def test_padding_rows_drop(self, quantized_model):
        """Bucketed A padding rows (slot = max_batch) must not touch state."""
        model, qparams = quantized_model
        engine = _engine(model, qparams, max_batch=4)
        import jax.numpy as jnp

        ids = np.zeros((2, 8), np.int32)
        ids[0, :3] = [5, 9, 17]
        cache0 = engine.new_cache()
        cache, logits, greedy = jax.jit(engine._admit_prefill_impl)(
            engine.params, cache0, jnp.asarray(ids),
            jnp.asarray(np.array([3, 1], np.int32)),
            jnp.asarray(np.array([2, 4], np.int32)),  # row 1 = padding
        )
        lengths = np.asarray(cache["lengths"])
        assert lengths[2] == 3 and lengths.sum() == 3

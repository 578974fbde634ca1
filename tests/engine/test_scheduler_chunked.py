"""Chunked continuous batching == per-step continuous batching (greedy).

``chunk > 1`` decodes between admission checks inside one compiled program
(the dispatch-amortizing serving mode). The outputs must be identical to the
per-step scheduler for every request, including requests that queue behind a
full batch and are admitted into reused slots, hit EOS mid-chunk, or run into
max_new_tokens / cache capacity.
"""

import numpy as np
import pytest

import jax

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.engine import ContinuousBatchingScheduler, InferenceEngine
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


def _run(model, params, chunk, prompts, eos, max_seq=48):
    engine = InferenceEngine(model, params, max_batch=2, max_seq=max_seq,
                             kv_quant=True)
    sched = ContinuousBatchingScheduler(engine, chunk=chunk)
    reqs = [
        sched.submit(p, max_new_tokens=m, eos_token_id=eos)
        for p, m in prompts
    ]
    sched.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_matches_per_step(quantized_model, chunk):
    model, qparams = quantized_model
    rng = np.random.default_rng(5)
    # 5 requests through 2 slots: forces queueing + slot reuse. Varied
    # max_new so finishes land mid-chunk.
    prompts = [
        (list(rng.integers(1, 128, size=int(rng.integers(3, 10)))),
         int(rng.integers(3, 14)))
        for _ in range(5)
    ]
    # The tiny random-init model repeats one token greedily; use an id it
    # will not emit as EOS so max_new/capacity paths are exercised, then a
    # separate case pins the EOS path.
    base = _run(model, qparams, 1, prompts, eos=None)
    chunked = _run(model, qparams, chunk, prompts, eos=None)
    assert chunked == base


def test_chunked_eos_freezes(quantized_model):
    model, qparams = quantized_model
    # Find the token the model actually emits greedily, make it EOS: the
    # request must finish at its first decode step in both modes.
    probe = _run(model, qparams, 1, [([5, 9, 17], 4)], eos=None)[0]
    eos = probe[1]
    base = _run(model, qparams, 1, [([5, 9, 17], 8)], eos=eos)
    chunked = _run(model, qparams, 8, [([5, 9, 17], 8)], eos=eos)
    assert chunked == base
    assert chunked[0][-1] == eos and len(chunked[0]) <= 3


def test_chunked_capacity_finish(quantized_model):
    model, qparams = quantized_model
    # max_seq small enough that the request hits cache capacity mid-chunk.
    base = _run(model, qparams, 1, [([1, 2, 3, 4], 64)], eos=None, max_seq=12)
    chunked = _run(model, qparams, 8, [([1, 2, 3, 4], 64)], eos=None, max_seq=12)
    assert chunked == base


@pytest.mark.parametrize("chunk", [1, 4])
def test_length_mirror_tracks_device(quantized_model, chunk):
    """The host-side lengths mirror must equal the device cache lengths for
    every occupied slot after every scheduler step (it replaces a per-round
    device fetch, so drift would silently corrupt capacity handling)."""
    model, qparams = quantized_model
    engine = InferenceEngine(model, qparams, max_batch=2, max_seq=24,
                             kv_quant=True)
    sched = ContinuousBatchingScheduler(engine, chunk=chunk)
    rng = np.random.default_rng(3)
    for _ in range(4):
        sched.submit(list(rng.integers(1, 128, size=int(rng.integers(2, 7)))),
                     max_new_tokens=int(rng.integers(2, 9)))
    steps = 0
    while sched.has_work and steps < 50:
        sched.step()
        steps += 1
        device = np.asarray(sched.cache["lengths"])
        for slot_id, req in enumerate(sched.slots):
            if req is not None:
                assert sched.lengths[slot_id] == device[slot_id], (
                    f"mirror drift at slot {slot_id}: "
                    f"{sched.lengths[slot_id]} vs {device[slot_id]}"
                )
    assert not sched.has_work


def test_chunked_sampled_decode(quantized_model):
    """Chunked mode with a uniform temperature: tokens sample inside the
    decode scan (per-step rng splits); outputs are valid ids and requests
    respect max_new_tokens."""
    from onnx_quantize_tpu.engine.sampling import SamplingParams

    model, qparams = quantized_model
    engine = InferenceEngine(model, qparams, max_batch=2, max_seq=48,
                             kv_quant=True)
    sched = ContinuousBatchingScheduler(engine, chunk=4)
    sp = SamplingParams(temperature=0.8, top_k=16)
    rng = np.random.default_rng(9)
    reqs = [
        sched.submit(list(rng.integers(1, 128, size=5)),
                     max_new_tokens=int(rng.integers(3, 11)), sampling=sp)
        for _ in range(3)
    ]
    sched.run()
    for r in reqs:
        assert r.done and 1 <= len(r.output) <= r.max_new_tokens
        assert all(0 <= t < 128 for t in r.output)


def _run_pipelined(model, params, chunk, pipeline, prompts, eos, max_seq=48,
                   narrow=False, max_batch=2):
    engine = InferenceEngine(model, params, max_batch=max_batch,
                             max_seq=max_seq, kv_quant=True)
    sched = ContinuousBatchingScheduler(engine, chunk=chunk, pipeline=pipeline)
    sched.narrow_admit = narrow
    reqs = [
        sched.submit(p, max_new_tokens=m, eos_token_id=eos)
        for p, m in prompts
    ]
    sched.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("pipeline", [2, 4])
@pytest.mark.parametrize("narrow", [False, True])
def test_planned_pipelined_admission_matches_per_step(quantized_model,
                                                      pipeline, narrow):
    """Planned mid-pipeline admissions: slots are refilled
    inside a pipelined group the moment their budget guarantees completion.
    9 requests with short budgets through 2 slots force multiple planned
    handoffs per group; outputs must equal the per-step scheduler exactly."""
    model, qparams = quantized_model
    rng = np.random.default_rng(11)
    prompts = [
        (list(rng.integers(1, 128, size=int(rng.integers(3, 10)))),
         int(rng.integers(2, 9)))
        for _ in range(9)
    ]
    base = _run(model, qparams, 1, prompts, eos=None)
    got = _run_pipelined(model, qparams, 4, pipeline, prompts, eos=None,
                         narrow=narrow)
    assert got == base


def test_planned_admission_with_early_eos(quantized_model):
    """EOS finishes a slot EARLIER than its budget predicted; the planned
    admission must still land correctly (the slot is simply frozen longer)."""
    model, qparams = quantized_model
    probe = _run(model, qparams, 1, [([5, 9, 17], 4)], eos=None)[0]
    eos = probe[1]  # the token the tiny model emits greedily
    rng = np.random.default_rng(13)
    prompts = [([5, 9, 17], 12)] + [
        (list(rng.integers(1, 128, size=4)), int(rng.integers(3, 8)))
        for _ in range(5)
    ]
    base = _run(model, qparams, 1, prompts, eos=eos)
    got = _run_pipelined(model, qparams, 4, 3, prompts, eos=eos)
    assert got == base


def test_planned_admission_capacity_finish(quantized_model):
    """Capacity freezes are also earlier-than-budget; planned reuse holds."""
    model, qparams = quantized_model
    prompts = [([1, 2, 3, 4], 64), ([9, 8], 64), ([7, 7, 7], 64)]
    base = _run(model, qparams, 1, prompts, eos=None, max_seq=12)
    got = _run_pipelined(model, qparams, 4, 3, prompts, eos=None, max_seq=12)
    assert got == base


def test_planned_admission_mixed_sampling(quantized_model):
    """Planned-admitted rows carry their own eos/sampling rows into the
    continuation rounds (arrays are rebuilt per round from the occupancy)."""
    from onnx_quantize_tpu.engine.sampling import SamplingParams

    model, qparams = quantized_model
    engine = InferenceEngine(model, qparams, max_batch=2, max_seq=48,
                             kv_quant=True)
    sched = ContinuousBatchingScheduler(engine, chunk=4, pipeline=3)
    rng = np.random.default_rng(17)
    sp = SamplingParams(temperature=0.7, top_k=8)
    reqs = []
    for i in range(6):
        reqs.append(sched.submit(
            list(rng.integers(1, 128, size=4)),
            max_new_tokens=int(rng.integers(3, 7)),
            sampling=sp if i % 2 else SamplingParams(),
        ))
    sched.run()
    for r in reqs:
        assert r.done and 1 <= len(r.output) <= r.max_new_tokens
        assert all(0 <= t < 128 for t in r.output)

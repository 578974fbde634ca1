"""Scheduler mid-decode interleaving: requests admitted
into slots freed while other slots are still decoding must not disturb the
in-flight sequences, and slot-local prefill must leave sibling KV intact."""

import numpy as np
import pytest

import jax

from onnx_quantize_tpu.engine import ContinuousBatchingScheduler, InferenceEngine
from onnx_quantize_tpu.engine.sampling import SamplingParams
from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config


@pytest.fixture(scope="module")
def tiny():
    model = Gemma3(Gemma3Config.tiny())
    params = model.init(jax.random.key(0))
    return model, params


def _greedy():
    return SamplingParams(temperature=0.0)


def test_admission_mid_decode_preserves_inflight_sequence(tiny):
    """A long request keeps decoding while short ones finish and new ones are
    admitted into the freed slot; the long request's output must be identical
    to a solo run."""
    model, params = tiny
    engine = InferenceEngine(model, params, max_batch=2, max_seq=64)

    # Solo run: the long request alone.
    solo = ContinuousBatchingScheduler(engine)
    long_solo = solo.submit([5, 6, 7, 8], max_new_tokens=12, sampling=_greedy())
    solo.run()

    # Interleaved: long request + a stream of short requests that finish and
    # free their slot mid-decode, triggering admissions while slot 0 decodes.
    engine2 = InferenceEngine(model, params, max_batch=2, max_seq=64)
    sched = ContinuousBatchingScheduler(engine2)
    long_req = sched.submit([5, 6, 7, 8], max_new_tokens=12, sampling=_greedy())
    shorts = [
        sched.submit([9, 10], max_new_tokens=3, sampling=_greedy())
        for _ in range(3)
    ]
    finished = sched.run()

    assert long_req.done and all(s.done for s in shorts)
    assert len(finished) == 4
    # At most 2 slots: the 3rd short was necessarily admitted mid-decode.
    assert long_req.output == long_solo.output
    # Short requests are identical repeats of the same prompt and must agree.
    assert shorts[0].output == shorts[1].output == shorts[2].output


def test_mid_decode_admission_actually_interleaves(tiny):
    """Admission really happens while another slot is mid-request (guard
    against the scheduler silently serializing)."""
    model, params = tiny
    engine = InferenceEngine(model, params, max_batch=2, max_seq=64)
    sched = ContinuousBatchingScheduler(engine)
    long_req = sched.submit([5, 6, 7, 8], max_new_tokens=10, sampling=_greedy())
    # max_new_tokens=4: a short request is admitted (1 token from its slot
    # prefill) and then survives the decode of its admitting step, so it is
    # observable in a slot after step() returns.
    short_a = sched.submit([9, 10], max_new_tokens=4, sampling=_greedy())
    short_b = sched.submit([11, 12], max_new_tokens=4, sampling=_greedy())

    admitted_short_b_while_long_active = False
    while sched.has_work:
        sched.step()
        if (
            not long_req.done
            and short_a.done
            and any(s is short_b for s in sched.slots)
        ):
            admitted_short_b_while_long_active = True
    assert admitted_short_b_while_long_active
    assert long_req.done and short_a.done and short_b.done


def test_slot_prefill_leaves_sibling_kv_intact(tiny):
    """The slot-masked prefill writes only its own slot's KV rows."""
    model, params = tiny
    engine = InferenceEngine(model, params, max_batch=2, max_seq=32)
    sched = ContinuousBatchingScheduler(engine)
    sched.submit([1, 2, 3], max_new_tokens=50, sampling=_greedy())
    sched.step()  # admit into slot 0, one decode
    k_slot0 = np.asarray(sched.cache["k"])[:, 0].copy()
    len_slot0 = int(np.asarray(sched.cache["lengths"])[0])

    # Admit a second request into slot 1 (prefill) without stepping decode:
    sched.submit([4, 5, 6, 7], max_new_tokens=50, sampling=_greedy())
    sched._admit()
    # slot 0 KV and length untouched by slot 1's prefill
    np.testing.assert_array_equal(np.asarray(sched.cache["k"])[:, 0], k_slot0)
    assert int(np.asarray(sched.cache["lengths"])[0]) == len_slot0
    assert int(np.asarray(sched.cache["lengths"])[1]) == 4


def test_eos_frees_slot_for_queue(tiny):
    """EOS mid-decode completes the request and the freed slot is reused."""
    model, params = tiny
    engine = InferenceEngine(model, params, max_batch=1, max_seq=64)
    sched = ContinuousBatchingScheduler(engine)
    # Discover the greedy step-0 token to use as the EOS sentinel.
    probe = ContinuousBatchingScheduler(engine)
    p = probe.submit([3, 4, 5], max_new_tokens=2, sampling=_greedy())
    probe.run()
    eos = p.output[0]

    a = sched.submit([3, 4, 5], max_new_tokens=50, sampling=_greedy(),
                     eos_token_id=eos)
    b = sched.submit([6, 7], max_new_tokens=2, sampling=_greedy())
    finished = sched.run()
    assert [r.request_id for r in finished] == [a.request_id, b.request_id]
    # a stopped at its EOS: the token list ends with (and contains one) EOS.
    assert a.output[-1] == eos
    assert len(a.output) < 50

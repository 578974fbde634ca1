"""Speculative serving: token-exactness vs the non-speculative scheduler.

Per-slot draft windows inside serve rounds (acceptance, EOS,
budgets per slot), pinned token-for-token against
``ContinuousBatchingScheduler`` on the same submissions — for a perfect
draft, a quantized draft, and an adversarial draft (speculation may only
change speed, never the stream).
"""

import numpy as np
import pytest

import jax

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.engine import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    SamplingParams,
    SpeculativeDecoder,
    SpeculativeScheduler,
)
from onnx_quantize_tpu.models.gemma3 import Gemma3, Gemma3Config

CFG = Gemma3Config.tiny(
    hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
    num_kv_heads=1, head_dim=32, vocab_size=128,
)

# 6 staggered requests through 3 slots exercises admission churn.
PROMPTS = [[5, 9, 17, 3], [11, 2], [7], [23, 4, 1], [2, 2, 2], [19, 8]]
MAX_NEW = [9, 5, 12, 7, 3, 8]


@pytest.fixture(scope="module")
def setup():
    model = Gemma3(CFG)
    params = model.init(jax.random.key(0))
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16)))
    adversarial = model.init(jax.random.key(99))
    return model, params, {"self": params, "quantized": qparams,
                           "adversarial": adversarial}


def _engine(model, params, max_batch=3, max_seq=64):
    return InferenceEngine(model, params, max_batch=max_batch,
                           max_seq=max_seq, kv_quant=True)


def _submit_all(sched, eos=None, temps=None):
    out = []
    for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW)):
        kw = dict(max_new_tokens=m)
        if eos is not None:
            kw["eos_token_id"] = eos
        if temps is not None:
            kw["sampling"] = SamplingParams(temperature=temps[i])
        out.append(sched.submit(p, **kw))
    return out


def _cb_outputs(model, params, eos=None):
    sched = ContinuousBatchingScheduler(_engine(model, params))
    reqs = _submit_all(sched, eos=eos)
    sched.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("draft_kind", ["self", "quantized", "adversarial"])
@pytest.mark.parametrize("k, rounds", [(3, 4), (2, 1)])
def test_greedy_exact_vs_cb_scheduler(setup, draft_kind, k, rounds):
    model, params, drafts = setup
    base = _cb_outputs(model, params)
    spec = SpeculativeDecoder(
        _engine(model, params), _engine(model, drafts[draft_kind]), k=k
    )
    sched = SpeculativeScheduler(spec, rounds=rounds)
    reqs = _submit_all(sched)
    sched.run()
    got = [r.output for r in reqs]
    assert got == base, (draft_kind, k, rounds)


def test_eos_exact_vs_cb_scheduler(setup):
    model, params, drafts = setup
    # Pick an EOS that actually occurs mid-stream in the greedy outputs.
    plain = _cb_outputs(model, params)
    eos = plain[0][2]
    base = _cb_outputs(model, params, eos=eos)
    spec = SpeculativeDecoder(
        _engine(model, params), _engine(model, drafts["quantized"]), k=3
    )
    sched = SpeculativeScheduler(spec, rounds=3)
    reqs = _submit_all(sched, eos=eos)
    sched.run()
    assert [r.output for r in reqs] == base


def test_sampled_rows_complete_and_respect_budgets(setup):
    """Sampled serving smoke: the rejection path runs per-slot; budgets/EOS
    hold. (Distributional exactness of sampled_accept is pinned in
    test_speculative.py's Monte-Carlo test.)"""
    model, params, drafts = setup
    spec = SpeculativeDecoder(
        _engine(model, params), _engine(model, drafts["quantized"]), k=3
    )
    sched = SpeculativeScheduler(spec, rounds=2, rng=jax.random.key(7))
    temps = [0.0, 0.9, 0.7, 0.0, 1.1, 0.5]  # mixed greedy + sampled batch
    reqs = _submit_all(sched, temps=temps)
    sched.run()
    for r, m in zip(reqs, MAX_NEW):
        assert r.done and 1 <= len(r.output) <= m
    # Greedy rows in the mixed batch still match the scalar-greedy stream.
    base = _cb_outputs(model, params)
    assert reqs[0].output == base[0]
    assert reqs[3].output == base[3]


def test_submit_validation(setup):
    model, params, _ = setup
    spec = SpeculativeDecoder(
        _engine(model, params), _engine(model, params), k=3
    )
    sched = SpeculativeScheduler(spec)
    with pytest.raises(ValueError, match="speculative window"):
        sched.submit(list(range(62)))  # no room for k+1
    with pytest.raises(ValueError, match="temperature-only"):
        sched.submit([1, 2], sampling=SamplingParams(temperature=0.8, top_k=5))

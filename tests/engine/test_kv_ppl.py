"""Perplexity through the engine's quantized-KV decode path.

SURVEY §7 hard-part (5): the window-scoring
perplexity tool (matching ``/root/reference/tools/perplexity.py:25-83``)
never touches the KV cache, so KV-quantization error was previously only
bounded by a 15%-of-max logits check. ``InferenceEngine.score_nll`` closes
that: it prefills ONE token and teacher-forces the rest through
``_decode_impl``, so every K/V row passes through the configured
quantize→dequantize chain before being attended — the NLL *is* the cache's
accuracy cost.

Three layers of evidence, all on the deterministic structured model
(``models/structured.py``):

1. Exactness: with fp KV the decode-path ppl equals the full-forward
   teacher-forced ppl (same math, different execution route) — pins the scan
   bookkeeping (positions, masks, length gating) bit-tight.
2. Pinned absolute ppl per KV mode at S=512. NOTE the int4 pin is BELOW fp:
   on this near-chance synthetic model (fp ppl 1240 on vocab 2048,
   ln-uniform 7.62) quantization noise can move ppl either way; the pin
   freezes the value, and layer 3 carries the direction-of-harm evidence.
3. Monotone logits distortion: mean |logits_kvq − logits_fp| along the
   teacher-forced trajectory must grow int8 → int4 (it measures cache error
   directly, independent of the model's predictive quality).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from onnx_quantize_tpu.engine import InferenceEngine
from onnx_quantize_tpu.models.structured import STRUCTURED_GEMMA3, zipf_tokens

S = 512
ATOL = 0.75  # same slack policy as tests/integration/test_structured_ppl.py

FWD_PPL = 1240.164  # full-forward teacher-forced oracle on these windows
KV_PINS = {
    False: 1240.167,   # decode path, fp KV — equals the forward oracle
    "int8": 1241.788,  # +1.62 ppl (+0.13%)
    "int4": 1228.763,  # -11.40 ppl; see module docstring (near-chance model)
}


@pytest.fixture(scope="module")
def structured():
    model, params = STRUCTURED_GEMMA3()
    tokens = zipf_tokens(2 * S, 2048).reshape(2, S)
    return model, params, tokens


def _forward_ppl(model, params, tokens):
    logits = model(params, jnp.asarray(tokens))
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    nll = -np.take_along_axis(
        np.asarray(logp[:, :-1]), tokens[:, 1:, None], -1
    )[..., 0]
    return float(np.exp(nll.mean()))


def test_fp_decode_path_matches_forward(structured):
    model, params, tokens = structured
    assert _forward_ppl(model, params, tokens) == pytest.approx(FWD_PPL, abs=0.05)
    eng = InferenceEngine(model, params, max_batch=2, max_seq=S, kv_quant=False)
    # Same math through a completely different route (1-token prefill +
    # 510-step decode scan with cache attends): agreement well inside f32
    # reduction-order noise pins the scan's position/mask/length bookkeeping.
    assert eng.score_ppl(tokens) == pytest.approx(FWD_PPL, abs=0.05)


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_kv_mode_ppl_pins(structured, kv):
    model, params, tokens = structured
    eng = InferenceEngine(model, params, max_batch=2, max_seq=S, kv_quant=kv)
    ppl = eng.score_ppl(tokens)
    assert ppl == pytest.approx(KV_PINS[kv], abs=ATOL), (
        f"kv={kv!r}: decode-path ppl {ppl:.3f} drifted from {KV_PINS[kv]:.3f}"
    )


def test_kv_quant_distortion_monotone(structured):
    """Cache error measured directly: |Δlogits| must grow with coarser KV."""
    model, params, tokens = structured
    Ssml = 128
    toks = tokens[:, :Ssml]
    outs = {}
    for kv in [False, "int8", "int4"]:
        eng = InferenceEngine(model, params, max_batch=2, max_seq=Ssml, kv_quant=kv)
        cache = eng.new_cache()
        cache, l0 = eng.prefill(
            cache, jnp.asarray(toks[:, :1]), jnp.asarray(np.ones(2, np.int32))
        )
        per = [np.asarray(l0)]
        for i in range(1, Ssml - 1):
            cache, lg = eng.decode(cache, jnp.asarray(toks[:, i]))
            per.append(np.asarray(lg))
        outs[kv] = np.stack(per, 1)
    fp = outs[False]
    rel8 = np.abs(outs["int8"] - fp).mean() / np.abs(fp).mean()
    rel4 = np.abs(outs["int4"] - fp).mean() / np.abs(fp).mean()
    # Frozen from the same run that froze KV_PINS: 0.0141 / 0.185.
    assert rel8 < 0.03, rel8
    assert rel4 < 0.30, rel4
    assert rel4 > 3 * rel8, (rel4, rel8)


def test_score_nll_row_chunking(structured):
    """N > max_batch rows chunk correctly and per-row lengths gate the sums."""
    model, params, tokens = structured
    eng = InferenceEngine(model, params, max_batch=2, max_seq=64, kv_quant="int8")
    ids = np.stack([tokens[0, :64], tokens[1, :64], tokens[0, 64:128]])
    lengths = np.array([64, 40, 64], np.int32)
    nll, cnt = eng.score_nll(ids, lengths)
    assert cnt.tolist() == [63, 39, 63]
    # Row 1 truncated at 40 must equal scoring the 40-token row directly.
    nll_b, cnt_b = eng.score_nll(ids[1:2, :40])
    assert cnt_b[0] == 39
    np.testing.assert_allclose(nll[1], nll_b[0], rtol=1e-5)

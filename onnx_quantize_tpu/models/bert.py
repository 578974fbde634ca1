"""BERT-style bidirectional encoder classifier — the integration-parity family.

The reference anchors its external accuracy claims on DistilBERT-SST2: it
exports the HF checkpoint to ONNX, quantizes it per config, reloads through
ORT, and asserts *exact* accuracies on a 100-sample GLUE validation slice
(``/root/reference/test/integration/bert/test_bert_weights_only.py:10-65``,
``test_bert_weights_inputs.py:11-68``, ``test_bert_weights_inputs_outputs.py:18-79``).
This environment has no network or HF cache, so this module provides the
JAX analogue end to end: the encoder architecture (post-LayerNorm
blocks, biased Gemm projections, [CLS] pooler + tanh, classification head —
the DistilBERT shape), a deterministic synthetic sentiment task, and a small
deterministic training loop that reaches DistilBERT-SST2-like accuracy
(~0.94). ``tests/integration/test_bert_classifier.py`` then mirrors the
reference's three integration files config-for-config with pinned absolute
accuracies.

The model is multi-input (``input_ids`` + ``attention_mask``), which also
exercises the dict-calibration path the reference handles at
``calibrate.py:228-236``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from onnx_quantize_tpu import nn
from onnx_quantize_tpu.nn.layers import Embedding
from onnx_quantize_tpu.nn.module import Context, InputSpec

__all__ = [
    "BertConfig",
    "BertClassifier",
    "synthetic_sst2",
    "train_classifier",
    "accuracy",
]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 512
    hidden_size: int = 128
    intermediate_size: int = 512
    num_layers: int = 2
    num_heads: int = 4
    max_seq: int = 48
    num_classes: int = 2
    layer_norm_eps: float = 1e-12  # BERT's default


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float):
        super().__init__()
        self.features = features
        self.eps = eps

    def init(self, rng):
        return {
            "w": jnp.ones((self.features,), jnp.float32),
            "b": jnp.zeros((self.features,), jnp.float32),
        }

    def __call__(self, params, x, ctx: Context | None = None):
        x32 = x.astype(jnp.float32)
        mean = jnp.mean(x32, axis=-1, keepdims=True)
        var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
        normed = (x32 - mean) * jax.lax.rsqrt(var + self.eps)
        return (normed * params["w"] + params["b"]).astype(x.dtype)


class BertSelfAttention(nn.Module):
    """Bidirectional MHA with biases (every projection is a Gemm site)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d, use_bias=True)
        self.k_proj = nn.Linear(d, d, use_bias=True)
        self.v_proj = nn.Linear(d, d, use_bias=True)
        self.o_proj = nn.Linear(d, d, use_bias=True)

    def __call__(self, params, x, mask, ctx: Context | None = None):
        cfg = self.cfg
        B, T, d = x.shape
        H = cfg.num_heads
        hd = d // H
        q = self.q_proj(params["q_proj"], x, ctx=ctx).reshape(B, T, H, hd)
        k = self.k_proj(params["k_proj"], x, ctx=ctx).reshape(B, T, H, hd)
        v = self.v_proj(params["v_proj"], x, ctx=ctx).reshape(B, T, H, hd)
        logits = jnp.einsum("bthd,bshd->bhts", q, k) / np.sqrt(hd)
        # Padding mask only — no causal mask (bidirectional encoder).
        logits = jnp.where(
            mask[:, None, None, :], logits.astype(jnp.float32), -1e30
        )
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, d)
        return self.o_proj(params["o_proj"], out, ctx=ctx)


class BertBlock(nn.Module):
    """Post-LayerNorm residual block (the original BERT/DistilBERT order)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attn = BertSelfAttention(cfg)
        self.ln_attn = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size, use_bias=True)
        self.fc_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size, use_bias=True)
        self.ln_mlp = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def __call__(self, params, x, mask, ctx: Context | None = None):
        x = self.ln_attn(
            params["ln_attn"], x + self.attn(params["attn"], x, mask, ctx=ctx)
        )
        h = jax.nn.gelu(self.fc_in(params["fc_in"], x, ctx=ctx))
        return self.ln_mlp(params["ln_mlp"], x + self.fc_out(params["fc_out"], h, ctx=ctx))


class BertClassifier(nn.Module):
    """Encoder + [CLS] pooler (dense+tanh) + classification head."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_embed = Embedding(cfg.max_seq, cfg.hidden_size)
        self.ln_embed = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.blocks = []
        for i in range(cfg.num_layers):
            block = BertBlock(cfg)
            setattr(self, f"layer.{i}", block)
            self.blocks.append(block)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, use_bias=True)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_classes, use_bias=True)
        self.input_specs = [
            InputSpec("input_ids", (cfg.max_seq,), np.int32),
            InputSpec("attention_mask", (cfg.max_seq,), np.int32),
        ]
        self.finalize()

    def __call__(self, params, input_ids, attention_mask=None,
                 ctx: Context | None = None):
        B, T = input_ids.shape
        if attention_mask is None:
            attention_mask = jnp.ones((B, T), jnp.int32)
        mask = attention_mask.astype(bool)
        pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None, :], (B, T))
        x = self.embed(params["embed"], input_ids) + self.pos_embed(
            params["pos_embed"], pos
        )
        x = self.ln_embed(params["ln_embed"], x)
        for i, block in enumerate(self.blocks):
            x = block(params[f"layer.{i}"], x, mask, ctx=ctx)
        cls = x[:, 0, :]  # [CLS] position
        pooled = jnp.tanh(self.pooler(params["pooler"], cls, ctx=ctx))
        return self.classifier(params["classifier"], pooled, ctx=ctx)


# ---------------------------------------------------------------------------
# Synthetic SST-2: a deterministic sentiment task the encoder must *learn*.
# ---------------------------------------------------------------------------

_CLS, _PAD = 1, 0


def _token_sentiment(vocab_size: int, seed: int = 5) -> np.ndarray:
    """Fixed per-token sentiment: ~1/4 positive, ~1/4 negative, rest neutral.

    Tokens are Zipf-ranked by id; positive/negative roles alternate across
    adjacent ranks (id % 4), so the frequency-weighted sentiment mass cancels
    and sentence totals concentrate near zero. Graded strengths in [0.5, 1.5]
    give a margin distribution — the trained model gets clear sentences right
    and fumbles marginal ones, like a real SST-2 classifier at ~0.94.
    """
    rng = np.random.default_rng(seed)
    s = np.zeros(vocab_size, np.float32)
    ids = np.arange(2, vocab_size)
    strength = rng.uniform(0.5, 1.5, vocab_size - 2).astype(np.float32)
    s[ids[ids % 4 == 0]] = strength[ids % 4 == 0]
    s[ids[ids % 4 == 1]] = -strength[ids % 4 == 1]
    return s


def synthetic_sst2(n: int, cfg: BertConfig, seed: int = 17):
    """Deterministic sentence batch: (input_ids, attention_mask, labels).

    Each sentence is [CLS] + tokens drawn from a Zipf-ranked categorical
    distribution over the vocab + PAD; the label is the sign of the summed
    token sentiment. Margins concentrate near zero (sentiments mostly cancel
    across a sentence), so the task is learnable to ~0.95 but not to 1.0 —
    matching the reference fixture's difficulty profile (fp32 ~0.94,
    ``test_bert_weights_only.py:64``). Fully vectorized: one categorical draw
    for the whole batch.
    """
    rng = np.random.default_rng(seed)
    sent = _token_sentiment(cfg.vocab_size)
    T = cfg.max_seq
    # Zipf-ranked token frequencies over real tokens [2, V).
    ranks = np.arange(2, cfg.vocab_size, dtype=np.float64)
    probs = ranks**-1.2
    probs /= probs.sum()
    toks = rng.choice(
        np.arange(2, cfg.vocab_size), size=(n, T - 1), p=probs
    ).astype(np.int32)
    lengths = rng.integers(T // 3, T - 1, size=n)
    pos = np.arange(T - 1)[None, :]
    valid = pos < lengths[:, None]
    ids = np.concatenate(
        [np.full((n, 1), _CLS, np.int32), np.where(valid, toks, _PAD)], axis=1
    )
    mask = np.concatenate(
        [np.ones((n, 1), np.int32), valid.astype(np.int32)], axis=1
    )
    totals = np.where(valid, sent[toks], 0.0).sum(axis=1)
    labels = (totals > 0).astype(np.int32)
    # ~3% deterministic label noise: real SST-2 has annotation ambiguity, so
    # even the fp32 model tops out near 0.94 (test_bert_weights_only.py:64).
    labels ^= (rng.random(n) < 0.03).astype(np.int32)
    return ids, mask, labels


def accuracy(model: BertClassifier, params, ids, mask, labels,
             batch_size: int = 64) -> float:
    """Greedy classification accuracy (the reference's eval loop shape,
    ``test_bert_weights_only.py:55-65``)."""
    fwd = jax.jit(lambda p, i, m: jnp.argmax(model(p, i, m), axis=-1))
    correct = 0
    for lo in range(0, len(ids), batch_size):
        preds = np.asarray(fwd(params, ids[lo : lo + batch_size], mask[lo : lo + batch_size]))
        correct += int((preds == labels[lo : lo + batch_size]).sum())
    return correct / len(ids)


def train_classifier(model: BertClassifier, steps: int = 400, batch_size: int = 64,
                     lr: float = 3e-4, seed: int = 23):
    """Deterministically train the classifier on synthetic SST-2 (CPU, ~20 s).

    Stands in for the reference's pretrained DistilBERT-SST2 download
    (``test/integration/bert/conftest.py``): fixed seeds end to end, Adam on
    softmax cross-entropy.
    """
    import optax

    cfg = model.cfg
    train_ids, train_mask, train_labels = synthetic_sst2(
        steps * batch_size, cfg, seed=seed
    )
    params = model.init(jax.random.key(seed))
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def loss_fn(p, i, m, y):
        logits = model(p, i, m)
        return jnp.mean(
            optax.softmax_cross_entropy_with_integer_labels(logits, y)
        )

    @jax.jit
    def step(p, s, i, m, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, i, m, y)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    for k in range(steps):
        lo = k * batch_size
        params, opt_state, _ = step(
            params, opt_state,
            train_ids[lo : lo + batch_size],
            train_mask[lo : lo + batch_size],
            train_labels[lo : lo + batch_size],
        )
    return params

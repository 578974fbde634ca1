"""Speculative decoding: a draft model proposes, the target verifies.

Latency-mode extension beyond the reference (which has no serving runtime at
all — SURVEY §2B): at small batch the decode step is weight-bandwidth-bound,
so verifying ``k`` drafted tokens in ONE target forward reads the target's
weights once instead of ``k`` times. The draft (typically a smaller or
lower-bit family member — e.g. quantized Gemma-3-270M drafting for 1B)
runs ``k`` cheap scan steps; the target then scores all ``k + 1`` positions
in a single mid-sequence masked forward and keeps the longest matching
prefix plus its own next token.

Greedy and EXACT: the emitted stream equals the target-only greedy decode
token-for-token regardless of draft quality (a bad draft only costs speed —
pinned by ``tests/engine/test_speculative.py`` with an adversarial draft).

Mechanics that make this cheap under XLA:

* static shapes everywhere — each round is draft-scan(k) + one (B, k+1)
  target forward inside ONE ``lax.scan`` over rounds; nothing recompiles as
  acceptance varies;
* rollback is free: rejected positions' KV entries are simply left stale —
  ``kv_positions`` masking (slot >= lengths) hides them and the next rounds
  overwrite them, so "undo" is one per-row lengths assignment;
* per-row acceptance: every batch row accepts its own prefix length, with
  per-row EOS/budget/capacity freezing exactly like ``engine.serve_chunk``.

Acceptance is capped at ``k - 1`` drafts per round so the draft cache never
falls behind the target cache (the uncapped final match would leave the
draft one KV entry short); each round therefore emits 1..k tokens.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.engine.engine import _FAR, InferenceEngine
from onnx_quantize_tpu.engine.sampling import sample_batch

logger = get_logger(__name__)

__all__ = ["SpeculativeDecoder", "sampled_accept"]


def sampled_accept(p_logits, q_logits, drafts, temps, rng):
    """Speculative-sampling acceptance (the rejection scheme of
    Leviathan et al. / Chen et al. 2023).

    ``p_logits``: (B, kp+1, V) target logits at the kp verified positions
    plus the bonus position; ``q_logits``: (B, kp, V) the draft's logits at
    its kp sampling steps; ``drafts``: (B, kp) the tokens the draft sampled;
    ``temps``: (B,) > 0 sampling temperatures (applied identically to both
    models). ``rng`` supplies the accept draws and the resample.

    Draft ``i`` is accepted with probability ``min(1, p(d_i)/q(d_i))``; at
    the first rejection the token is resampled from the residual
    ``norm(relu(p - q))``, and when every draft accepts the bonus token is
    drawn from ``p`` at position kp. Returns ``(tokens (B, kp+1), n (B,))``
    — ``n`` accepted drafts in ``tokens[:, :n]`` and the final token at
    column ``n``. The marginal distribution of the emitted stream equals
    target-only sampling EXACTLY for any draft (the draft only changes
    speed) — pinned by a Monte-Carlo test against the analytic target
    distribution (``tests/engine/test_speculative.py``).
    """
    B, kp, V = q_logits.shape
    t = jnp.maximum(temps, 1e-6)[:, None, None]
    logp = jax.nn.log_softmax(p_logits.astype(jnp.float32) / t, axis=-1)
    logq = jax.nn.log_softmax(q_logits.astype(jnp.float32) / t, axis=-1)
    r_acc, r_res = jax.random.split(rng)

    lp = jnp.take_along_axis(logp[:, :kp], drafts[..., None], axis=-1)[..., 0]
    lq = jnp.take_along_axis(logq, drafts[..., None], axis=-1)[..., 0]
    u = jax.random.uniform(r_acc, (B, kp))
    accept = u < jnp.exp(jnp.minimum(lp - lq, 0.0))
    n = jnp.sum(jnp.cumprod(accept.astype(jnp.int32), axis=1), axis=1)  # 0..kp

    # Final token: residual distribution at the per-row stop position.
    p_n = jnp.take_along_axis(
        jnp.exp(logp), n[:, None, None], axis=1
    )[:, 0]  # (B, V)
    q_pad = jnp.concatenate(
        [jnp.exp(logq), jnp.zeros((B, 1, V), jnp.float32)], axis=1
    )
    q_n = jnp.take_along_axis(q_pad, n[:, None, None], axis=1)[:, 0]
    all_ok = (n == kp)[:, None]
    resid = jnp.where(all_ok, p_n, jnp.maximum(p_n - q_n, 0.0))
    mass = jnp.sum(resid, axis=-1, keepdims=True)
    # Degenerate residual (numerically empty) falls back to p_n.
    resid = jnp.where(mass > 1e-9, resid, p_n)
    final = jax.random.categorical(
        r_res, jnp.log(resid + 1e-30), axis=-1
    ).astype(jnp.int32)

    cols = jnp.arange(kp + 1, dtype=jnp.int32)[None, :]
    drafts_pad = jnp.concatenate(
        [drafts, jnp.zeros((B, 1), jnp.int32)], axis=1
    )
    tokens = jnp.where(
        cols == n[:, None], final[:, None],
        jnp.where(cols < n[:, None], drafts_pad, 0),
    )
    return tokens, n


class SpeculativeDecoder:
    """Greedy speculative decoding over a (target, draft) engine pair."""

    def __init__(self, target: InferenceEngine, draft: InferenceEngine,
                 k: int = 4):
        if target.max_batch != draft.max_batch or target.max_seq != draft.max_seq:
            raise ValueError(
                "target and draft engines must share max_batch/max_seq "
                f"(got {target.max_batch}/{target.max_seq} vs "
                f"{draft.max_batch}/{draft.max_seq})"
            )
        if target.mesh is not None or draft.mesh is not None:
            raise NotImplementedError("speculative decoding is single-chip for now")
        assert k >= 2, "k < 2 never accepts a draft (acceptance cap is k - 1)"
        self.target = target
        self.draft = draft
        self.k = k
        self._jit = jax.jit(
            self._impl, donate_argnums=(2, 3), static_argnums=(9, 10)
        )

    # ── device program ───────────────────────────────────────────────────

    def _verify(self, params, cache, ids, act):
        """Target forward over ids (B, k+1) appended at each row's length.

        Returns (cache, greedy (B, k+1)); lengths are NOT advanced here —
        the acceptance logic assigns them.
        """
        eng = self.target
        B, T = ids.shape
        L = cache["lengths"]
        positions = L[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]
        positions = jnp.where(act[:, None], positions, eng.max_seq)
        slot = jnp.arange(eng.max_seq, dtype=jnp.int32)[None, :]
        visible = (L + T * act.astype(jnp.int32))[:, None]
        kv_positions = jnp.where(slot < visible, slot, _FAR)
        holder = {"cache": dict(cache)}
        # kv_window: contiguous per-row writes via dynamic_update_slice —
        # the general scatter costs cache traffic proportional to max_seq
        # for offset windows.
        logits = eng._forward(
            params, holder, ids, positions, kv_positions, kv_window=(L, act)
        )
        return holder["cache"], logits

    def _impl(self, tgt_params, dft_params, tgt_cache, dft_cache, tokens,
              budgets, eos, temps, rng, rounds: int, sampled: bool):
        k = self.k
        eos_on = eos >= 0
        done0 = budgets <= 0
        round_rngs = jax.random.split(rng, rounds)

        def round_body(carry, round_rng):
            tgt_cache, dft_cache, toks, done, budgets = carry
            # Rows without room for the whole k+1 window freeze (capacity).
            cap = tgt_cache["lengths"] + k + 1 > self.target.max_seq
            act = jnp.logical_not(jnp.logical_or(done, cap))
            L = tgt_cache["lengths"]
            step_rngs = jax.random.split(round_rng, k + 1)

            # 1) draft: k scan steps (greedy, or per-row-temperature sampled
            #    — the acceptance math needs the draft's own q logits).
            def dstep(c, step_rng):
                cache, t = c
                cache, logits = self.draft._decode_impl(dft_params, cache, t, act)
                if sampled:
                    nxt = sample_batch(
                        logits, step_rng, temps,
                        jnp.zeros_like(temps, jnp.int32),
                        jnp.ones_like(temps),
                        need_temp=True, need_topk=False, need_topp=False,
                    )
                else:
                    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                out = (nxt, logits) if sampled else (nxt, nxt)
                return (cache, nxt), out

            (dft_cache, _), (drafts, q_all) = jax.lax.scan(
                dstep, (dft_cache, toks), step_rngs[:k]
            )
            drafts = drafts.T  # (B, k)

            # 2) target verifies [t0, d_1..d_k] in one forward.
            ids = jnp.concatenate([toks[:, None], drafts], axis=1)
            tgt_cache, logits = self._verify(tgt_params, tgt_cache, ids, act)

            if sampled:
                # 3s) rejection-sampling acceptance over the first k-1 drafts
                #     (cap keeps the draft cache in lockstep; see class doc).
                q_logits = jnp.transpose(q_all, (1, 0, 2))[:, : k - 1]
                emitted_toks, n = sampled_accept(
                    logits[:, :k], q_logits, drafts[:, : k - 1], temps,
                    step_rngs[k],
                )
            else:
                # 3g) greedy: longest matching prefix (capped at k-1), plus
                #     the target's own token.
                greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                match = (drafts[:, : k - 1] == greedy[:, : k - 1]).astype(jnp.int32)
                n = jnp.sum(jnp.cumprod(match, axis=1), axis=1)  # 0..k-1
                emitted_toks = greedy[:, :k]
            m = n + 1  # tokens this round before EOS/budget cuts

            # EOS cut: first EOS among the emitted prefix ends the row there.
            emit_mask = jnp.arange(k)[None, :] < m[:, None]
            is_eos = emit_mask & eos_on[:, None] & (emitted_toks == eos[:, None])
            any_eos = jnp.any(is_eos, axis=1)
            first_eos = jnp.argmax(is_eos, axis=1)  # valid where any_eos
            m = jnp.where(any_eos, first_eos + 1, m)
            m = jnp.minimum(m, budgets)
            m = jnp.where(act, m, 0)

            next_tok = jnp.take_along_axis(
                emitted_toks, jnp.maximum(m - 1, 0)[:, None], axis=1
            )[:, 0]
            toks = jnp.where(m > 0, next_tok, toks)
            new_len = L + m
            tgt_cache["lengths"] = jnp.where(act, new_len, tgt_cache["lengths"])
            dft_cache["lengths"] = jnp.where(act, new_len, dft_cache["lengths"])
            budgets = budgets - m
            done = jnp.logical_or(done, any_eos & act)
            done = jnp.logical_or(done, budgets <= 0)
            done = jnp.logical_or(done, cap)

            out = jnp.concatenate(
                [
                    emitted_toks,
                    m[:, None],
                    done.astype(jnp.int32)[:, None],
                    tgt_cache["lengths"][:, None],
                ],
                axis=1,
            ).astype(jnp.int32)
            return (tgt_cache, dft_cache, toks, done, budgets), out

        carry = (tgt_cache, dft_cache, tokens, done0, budgets)
        (tgt_cache, dft_cache, _, _, _), outs = jax.lax.scan(
            round_body, carry, round_rngs
        )
        # outs: (rounds, B, k+3) -> (B, rounds, k+3)
        return tgt_cache, dft_cache, jnp.transpose(outs, (1, 0, 2))

    # ── host API ─────────────────────────────────────────────────────────

    def decode(self, tgt_cache, dft_cache, tokens, rounds: int, *,
               budgets, eos=None, temps=None, rng=None):
        """Run ``rounds`` speculative rounds in one device program.

        ``tokens``: (B,) current next-input token per row; ``budgets``: (B,)
        remaining tokens per row (0 => row inactive); ``eos``: (B,) EOS id or
        -1. ``temps``: None for greedy, or (B,) per-row temperatures — the
        sampled path runs the full rejection scheme (:func:`sampled_accept`),
        so the output stream's distribution equals target-only sampling
        (top-k/top-p are not supported in speculative mode). Returns
        ``(tgt_cache, dft_cache, blob (B, rounds, k+3))`` with per-round
        columns ``[tok_1..tok_k, emitted, done, lengths]`` — the first
        ``emitted`` of the toks are this round's tokens.
        """
        B = self.target.max_batch
        if eos is None:
            eos = np.full((B,), -1, np.int32)
        sampled = temps is not None
        if temps is None:
            temps = np.zeros((B,), np.float32)
        if rng is None:
            rng = jax.random.key(0)
        return self._jit(
            self.target.params, self.draft.params, tgt_cache, dft_cache,
            jnp.asarray(tokens, jnp.int32), jnp.asarray(budgets, jnp.int32),
            jnp.asarray(eos, jnp.int32), jnp.asarray(temps, jnp.float32),
            rng, rounds, sampled,
        )

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 eos_token_id: int | None = None, temperature: float = 0.0,
                 rng=None) -> list[list[int]]:
        """Batched generation; greedy (exact target-greedy stream) or, with
        ``temperature > 0``, speculative sampling (target-distribution-exact
        via the rejection scheme)."""
        tgt, dft = self.target, self.draft
        B = tgt.max_batch
        assert len(prompts) <= B
        ids = np.zeros((B, max(max(len(p) for p in prompts), 1)), np.int32)
        lengths = np.zeros((B,), np.int32)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
            lengths[i] = max(len(p), 1)
        lengths = np.maximum(lengths, 1)

        if rng is None:
            rng = jax.random.key(0)
        tgt_cache, logits, first = tgt.prefill(
            tgt.new_cache(), ids, lengths, with_tokens=True
        )
        if temperature > 0:
            from onnx_quantize_tpu.engine.sampling import SamplingParams, sample

            rng, first_rng = jax.random.split(rng)
            first = sample(logits, first_rng, SamplingParams(temperature=temperature))
        # The draft only needs its cache populated; its logits are unused.
        dft_cache, _ = dft.prefill(dft.new_cache(), ids, lengths)
        first = np.asarray(first)

        outputs: list[list[int]] = [[] for _ in prompts]
        budgets = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int32)
        tokens = np.zeros((B,), np.int32)
        for i, p in enumerate(prompts):
            outputs[i].append(int(first[i]))
            budgets[i] = max_new_tokens - 1
            if eos_token_id is not None:
                eos[i] = eos_token_id
                if first[i] == eos_token_id:
                    budgets[i] = 0
            tokens[i] = first[i]

        temps = (
            np.full((B,), temperature, np.float32) if temperature > 0 else None
        )
        # Worst case one token per round; typical is 2-4x fewer rounds.
        while budgets.max() > 0:
            rounds = max(int(np.ceil(budgets.max() / self.k)), 1)
            rng, step_rng = jax.random.split(rng)
            tgt_cache, dft_cache, blob = self.decode(
                tgt_cache, dft_cache, tokens, rounds, budgets=budgets, eos=eos,
                temps=temps, rng=step_rng,
            )
            blob = np.asarray(blob)
            for i in range(len(prompts)):
                for r in range(rounds):
                    row = blob[i, r]
                    emitted = row[self.k]
                    outputs[i].extend(int(t) for t in row[:emitted])
            emitted_total = blob[:, :, self.k].sum(axis=1)
            done = blob[:, -1, self.k + 1].astype(bool)
            budgets = np.where(done, 0, budgets - emitted_total).astype(np.int32)
            for i in range(len(prompts)):
                if outputs[i]:
                    tokens[i] = outputs[i][-1]
        return outputs

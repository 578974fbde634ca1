"""Speculative decoding composed with continuous batching.

``SpeculativeDecoder`` alone is a standalone decode loop,
so the production-shaped question — does speculation still pay under
random-load serving with admissions? — was unanswerable. This scheduler
closes the gap: the CB scheduler's slot/queue bookkeeping drives
``SpeculativeDecoder.decode`` rounds, so every round runs per-slot draft
windows (k draft steps + ONE target verify) with per-slot acceptance, EOS,
budgets, and capacity freezing — all inside one device program per call.

Semantics:

* Greedy rows emit token-for-token the target-only greedy stream (pinned
  against ``ContinuousBatchingScheduler`` outputs in
  ``tests/engine/test_spec_scheduler.py``), regardless of draft quality.
* Sampled rows use the rejection scheme (:func:`sampled_accept`) —
  temperature only; top-k/top-p requests are rejected at submit. Greedy and
  sampled rows mix in one batch (temp-0 rows run the sampled path with
  t→1e-6, which is numerically exact argmax).
* Capacity: a row freezes when it lacks room for a full k+1 window
  (``lengths + k + 1 > max_seq``), i.e. up to ``k`` tokens earlier than the
  non-speculative scheduler's exact-capacity stop. Size ``max_seq`` with
  that headroom when comparing.

Admission costs two masked prefills per group (target + draft caches).
Amortization note: a freed slot waits at most ``rounds`` speculative rounds
(each 1..k emitted tokens) before the next admission opportunity — the same
chunk-boundary trade the CB scheduler makes.
"""

from __future__ import annotations

import itertools
import time
from collections import deque

import jax
import numpy as np

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.engine.scheduler import Request
from onnx_quantize_tpu.engine.speculative import SpeculativeDecoder

logger = get_logger(__name__)

__all__ = ["SpeculativeScheduler"]


class SpeculativeScheduler:
    """Admits requests into engine slots and steps speculative rounds."""

    def __init__(self, spec: SpeculativeDecoder, rounds: int = 4,
                 rng: jax.Array | None = None):
        assert rounds >= 1
        self.spec = spec
        self.rounds = rounds
        self.tgt_cache = spec.target.new_cache()
        self.dft_cache = spec.draft.new_cache()
        B = spec.target.max_batch
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * B
        self.next_tokens = np.zeros((B,), np.int32)
        self.lengths = np.zeros((B,), np.int32)
        self.rng = rng if rng is not None else jax.random.key(0)
        self._id_counter = itertools.count()
        self.completed: list[Request] = []
        # live_rounds counts (slot, round) pairs where the slot was running;
        # emitted/live_rounds - 1 over k is the measured acceptance rate.
        self.stats = {"calls": 0, "live_rounds": 0, "emitted": 0}

    # ── submission ───────────────────────────────────────────────────────

    def submit(self, prompt: list[int], **kwargs) -> Request:
        request = Request(request_id=next(self._id_counter), prompt=prompt,
                          **kwargs)
        if request.use_prefix:
            raise NotImplementedError(
                "prefix caching is not composed with speculative serving yet"
            )
        sp = request.sampling
        if sp.temperature > 0 and (sp.top_k > 0 or sp.top_p < 1.0):
            raise ValueError(
                "speculative serving supports temperature-only sampling "
                "(the rejection scheme has no top-k/top-p variant)"
            )
        eng = self.spec.target
        if len(prompt) + self.spec.k + 1 > eng.max_seq:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no room for a k+1="
                f"{self.spec.k + 1} speculative window in max_seq={eng.max_seq}"
            )
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        request.t_submitted = time.monotonic()
        self.queue.append(request)
        return request

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    # ── admission (two masked prefills: target + draft) ──────────────────

    def _assign_slots(self) -> list[tuple[int, Request]]:
        admitted: list[tuple[int, Request]] = []
        for slot_id, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            request = self.queue.popleft()
            request.t_admitted = time.monotonic()
            self.slots[slot_id] = request
            admitted.append((slot_id, request))
            logger.debug("spec: admitted request %d into slot %d",
                         request.request_id, slot_id)
        return admitted

    def _admit(self, admitted) -> None:
        tgt, dft = self.spec.target, self.spec.draft
        B = tgt.max_batch
        longest = max(max(len(r.prompt), 1) for _, r in admitted)
        T_pad = min(-(-longest // 64) * 64, tgt.max_seq)
        ids = np.zeros((B, max(T_pad, longest)), np.int32)
        lengths = self.lengths.copy()
        mask = np.zeros((B,), bool)
        for slot_id, request in admitted:
            ids[slot_id, : len(request.prompt)] = request.prompt
            lengths[slot_id] = max(len(request.prompt), 1)
            mask[slot_id] = True
        self.lengths = lengths.copy()
        self.tgt_cache, logits, greedy = tgt.prefill(
            self.tgt_cache, ids, lengths, slot_mask=mask, with_tokens=True
        )
        # Draft cache rows just need the prompt KV; logits unused.
        self.dft_cache, _ = dft.prefill(
            self.dft_cache, ids, lengths, slot_mask=mask
        )

        greedy = np.asarray(greedy)
        sampled_rows = [
            (s, r) for s, r in admitted if r.sampling.temperature > 0
        ]
        tokens = {s: int(greedy[s]) for s, _ in admitted}
        if sampled_rows:
            from onnx_quantize_tpu.engine.sampling import sample, SamplingParams

            by_params: dict[SamplingParams, list[int]] = {}
            for slot_id, request in sampled_rows:
                by_params.setdefault(request.sampling, []).append(slot_id)
            for params, slot_ids in by_params.items():
                self.rng, step_rng = jax.random.split(self.rng)
                toks = np.asarray(sample(logits, step_rng, params))
                for slot_id in slot_ids:
                    tokens[slot_id] = int(toks[slot_id])

        for slot_id, request in admitted:
            request.output.append(tokens[slot_id])
            self.next_tokens[slot_id] = tokens[slot_id]
            hit_eos = (
                request.eos_token_id is not None
                and tokens[slot_id] == request.eos_token_id
            )
            if hit_eos or len(request.output) >= request.max_new_tokens:
                self._finish(slot_id, request)

    def _finish(self, slot_id: int, request: Request) -> None:
        request.done = True
        request.t_finished = time.monotonic()
        self.completed.append(request)
        self.slots[slot_id] = None
        logger.debug("spec: request %d finished", request.request_id)

    # ── stepping ─────────────────────────────────────────────────────────

    def step(self) -> list[Request]:
        """One scheduler iteration: admit, run speculative rounds, collect."""
        admitted = self._assign_slots()
        if admitted:
            self._admit(admitted)
        occupied = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not occupied:
            return self._drain_completed()

        k = self.spec.k
        B = self.spec.target.max_batch
        budgets = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int32)
        temps = np.zeros((B,), np.float32)
        any_sampled = False
        for slot_id, request in occupied:
            budgets[slot_id] = request.max_new_tokens - len(request.output)
            if request.eos_token_id is not None:
                eos[slot_id] = request.eos_token_id
            t = request.sampling.temperature
            temps[slot_id] = max(t, 0.0)
            any_sampled |= t > 0
        # Each round emits >= 1 token per live row, so the max remaining
        # budget bounds the useful rounds this call.
        rounds = int(min(self.rounds, max(int(budgets.max()), 1)))

        self.rng, step_rng = jax.random.split(self.rng)
        self.tgt_cache, self.dft_cache, blob = self.spec.decode(
            self.tgt_cache, self.dft_cache, self.next_tokens, rounds,
            budgets=budgets, eos=eos,
            temps=temps if any_sampled else None, rng=step_rng,
        )
        blob = np.asarray(blob)  # (B, rounds, k+3)
        self.lengths = blob[:, -1, k + 2].astype(np.int32)
        self.stats["calls"] += 1
        for slot_id, request in occupied:
            for r in range(rounds):
                row = blob[slot_id, r]
                emitted = int(row[k])
                self.stats["live_rounds"] += 1
                self.stats["emitted"] += emitted
                request.output.extend(int(t) for t in row[:emitted])
                if row[k + 1]:  # done: EOS, budget, or capacity freeze
                    self._finish(slot_id, request)
                    break
            if request.output:
                self.next_tokens[slot_id] = request.output[-1]
        return self._drain_completed()

    def _drain_completed(self) -> list[Request]:
        out, self.completed = self.completed, []
        return out

    def run(self) -> list[Request]:
        """Run until all submitted requests complete; returns finish order."""
        finished: list[Request] = []
        while self.has_work:
            finished.extend(self.step())
        return finished

"""Continuous batching scheduler.

Keeps the decode batch full: finished sequences release their slot, queued
requests are admitted into free slots, and decode runs over all active slots —
the standard continuous-batching loop (SURVEY.md §2B, BASELINE.json config 5),
host-orchestrated over the engine's compiled programs.

Two modes:

* ``chunk == 1`` — the classic per-step loop (reference-shaped): one masked
  prefill call per admission round, one decode call + host-side sampling per
  token. Simple, fully general, and the equivalence oracle for the fast path.
* ``chunk > 1`` — the serving fast path: each round is ONE device program
  (``engine.serve_chunk``) folding admission prefill, per-slot first-token
  sampling, and ``chunk`` decode steps, returning one packed int32 blob.
  Every host sync has a fixed cost, so collapsing the old prefill + decode +
  sample syncs into one removes two of the three per round.
  Sampling parameters, EOS ids, and token budgets are per-slot arrays — mixed
  batches (heterogeneous temperature/top-k/top-p/EOS) run in the same
  program. A sequence finishing mid-chunk holds its slot until the chunk
  boundary (at most ``chunk - 1`` wasted steps), but frozen slots stop
  writing KV and stop advancing lengths the moment they hit EOS, budget, or
  capacity.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.engine.engine import InferenceEngine
from onnx_quantize_tpu.engine.sampling import (
    SamplingParams,
    batch_sampling_arrays,
    sample,
)

logger = get_logger(__name__)

__all__ = ["Request", "ContinuousBatchingScheduler"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: list[int]
    max_new_tokens: int = 32
    sampling: SamplingParams = SamplingParams()
    eos_token_id: int | None = None
    # True when ``prompt`` is the SUFFIX after the scheduler's registered
    # shared prefix (see ``register_prefix``) — admission implants the
    # cached prefix KV and prefills only the suffix.
    use_prefix: bool = False
    # Filled by the scheduler:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Host-side latency timestamps (time.monotonic): queued at submit(),
    # admitted when the request takes a slot, finished at completion.
    t_submitted: float = 0.0
    t_admitted: float = 0.0
    t_finished: float = 0.0


class ContinuousBatchingScheduler:
    """Admits requests into engine slots and steps the decode batch."""

    def __init__(self, engine: InferenceEngine, rng: jax.Array | None = None,
                 chunk: int = 1, pipeline: int = 1):
        assert chunk >= 1 and pipeline >= 1
        self.engine = engine
        self.chunk = chunk
        # pipeline > 1 (serve mode only): dispatch up to this many serve
        # rounds back-to-back using the device-resident carry BEFORE reading
        # any result blob — the per-round host sync then hides behind the
        # next rounds' device compute.
        # Admissions happen only at group boundaries, so a freed slot waits
        # at most pipeline*chunk steps; outputs are unchanged (each row's
        # tokens are independent of batch composition, and frozen slots stop
        # emitting in-program).
        self.pipeline = pipeline
        # Narrow admission (serve mode, single-chip): admission groups of
        # <= max_batch/2 run the (A, T_pad) rows-only prefill inside the
        # serve program instead of the full (B, T_pad) masked prefill.
        # Bit-identical outputs, strictly less admission compute. Default ON:
        # planned per-round admissions make admission rounds frequent, and
        # prefill-dominated workloads pay the full masked prefill each
        # time. Cost: each
        # (A, T_pad) bucket adds a compiled serve variant to WARMUP (not
        # steady state) — set False for short-lived schedulers on
        # compile-expensive runtimes.
        self.narrow_admit = True
        self.cache = engine.new_cache()
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * engine.max_batch
        self.next_tokens = np.zeros((engine.max_batch,), np.int32)
        # Host mirror of cache["lengths"]. In serve mode it rides along in the
        # round's result blob (free); in per-step mode the scheduler tracks
        # every transition so serving never pays a device fetch for lengths.
        self.lengths = np.zeros((engine.max_batch,), np.int32)
        self.rng = rng if rng is not None else jax.random.key(0)
        self._id_counter = itertools.count()
        self.completed: list[Request] = []
        # Sticky sampler-variant flags: once a round needs temperature/top-k/
        # top-p, keep the superset variant (semantically identical — disabled
        # rows are no-ops) so request churn doesn't flip-flop recompiles.
        self._variant: tuple[bool, bool, bool] = (False, False, False)
        # Shared prompt-prefix cache (register_prefix): KV snapshot + length.
        self._prefix: dict | None = None
        self._prefix_len = 0
        # Serve-mode utilization accounting:
        # every dispatched round contributes B*chunk slot-steps; each is spent
        # as an emitted token, a frozen-done step (request finished, slot
        # waiting), or an empty-slot step. emitted/slot_steps is the
        # scheduler's occupancy of the fixed-batch decode ceiling.
        self.stats = {
            "rounds": 0, "slot_steps": 0, "emitted": 0,
            "admit_rounds": 0, "planned_admits": 0, "boundary_admits": 0,
        }

    def register_prefix(self, tokens: list[int]) -> int:
        """Cache a shared prompt prefix's KV once; later ``submit(...,
        use_prefix=True)`` requests pass only their SUFFIX and admission
        skips the prefix's prefill entirely (the system-prompt TTFT saving).

        Returns the prefix length. One prefix per scheduler; re-registering
        replaces it (in-flight prefix requests keep their implanted rows).
        """
        if not tokens:
            raise ValueError("prefix must be non-empty")
        if len(tokens) >= self.engine.max_seq:
            raise ValueError(
                f"prefix length {len(tokens)} leaves no room in max_seq="
                f"{self.engine.max_seq}"
            )
        B = self.engine.max_batch
        ids = np.zeros((B, len(tokens)), np.int32)
        ids[0, :] = tokens
        lengths = np.zeros((B,), np.int32)
        lengths[0] = len(tokens)
        mask = np.zeros((B,), bool)
        mask[0] = True
        # Throwaway prefill into slot 0 of a scratch cache, then snapshot.
        scratch, _ = self.engine.prefill(
            self.engine.new_cache(), ids, np.maximum(lengths, 1), slot_mask=mask
        )
        self._prefix = self.engine.snapshot_prefix(scratch, 0, len(tokens))
        self._prefix_len = len(tokens)
        return self._prefix_len

    def submit(self, prompt: list[int], **kwargs) -> Request:
        request = Request(request_id=next(self._id_counter), prompt=prompt, **kwargs)
        total = len(prompt)
        if request.use_prefix:
            if self._prefix is None:
                raise ValueError("use_prefix=True but no prefix registered")
            if len(prompt) < 1:
                raise ValueError("prefix requests need >= 1 suffix token")
            total += self._prefix_len
        if total > self.engine.max_seq:
            raise ValueError(
                f"prompt length {total} exceeds the engine's "
                f"max_seq={self.engine.max_seq}; KV writes past capacity would "
                "be silently dropped — truncate the prompt or raise max_seq"
            )
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        request.t_submitted = time.monotonic()
        self.queue.append(request)
        return request

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    # ── admission ────────────────────────────────────────────────────────

    def _assign_slots(self) -> list[tuple[int, Request]]:
        """Host-only: move queued requests into free slots."""
        admitted: list[tuple[int, Request]] = []
        for slot_id, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            request = self.queue.popleft()
            request.t_admitted = time.monotonic()
            self.slots[slot_id] = request
            admitted.append((slot_id, request))
            logger.debug("admitted request %d into slot %d", request.request_id, slot_id)
        return admitted

    def _build_admit(self, admitted, offset: int = 0):
        """Padded (ids, lengths, mask) for a masked batch prefill.

        The padded width is bucketed to a multiple of 64 so arbitrary prompt
        lengths reuse a handful of compiled programs instead of one per
        distinct length — on runtimes with minutes-long compiles, per-length
        compilation would dwarf the serving time. ``offset`` shifts the
        recorded lengths by a shared implanted-prefix length (the ids stay
        suffix-only)."""
        B = self.engine.max_batch
        longest = max(max(len(r.prompt), 1) for _, r in admitted)
        T_pad = min(-(-longest // 64) * 64, self.engine.max_seq)
        ids = np.zeros((B, max(T_pad, longest)), np.int32)
        lengths = self.lengths.copy()
        mask = np.zeros((B,), bool)
        for slot_id, request in admitted:
            ids[slot_id, : len(request.prompt)] = request.prompt
            lengths[slot_id] = offset + max(len(request.prompt), 1)
            mask[slot_id] = True
        return ids, lengths, mask

    def _build_admit_narrow(self, admitted):
        """(ids (A, T_pad), lengths (A,), slots (A,)) for the rows-only
        admission prefill. A buckets to a power of two (compile-count
        control, same rationale as the T_pad bucketing); padding rows carry
        ``slot = max_batch`` so every scatter drops them."""
        B = self.engine.max_batch
        longest = max(max(len(r.prompt), 1) for _, r in admitted)
        T_pad = min(-(-longest // 64) * 64, self.engine.max_seq)
        A = 1
        while A < len(admitted):
            A *= 2
        A = min(A, B)
        ids = np.zeros((A, max(T_pad, longest)), np.int32)
        lengths = np.ones((A,), np.int32)
        slots = np.full((A,), B, np.int32)
        for i, (slot_id, request) in enumerate(admitted):
            ids[i, : len(request.prompt)] = request.prompt
            lengths[i] = max(len(request.prompt), 1)
            slots[i] = slot_id
            self.lengths[slot_id] = lengths[i]
        return ids, lengths, slots

    def _prefill_group(self, admitted, prefixed: bool) -> None:
        """ONE masked prefill call for an admission group + first tokens."""
        ids, new_lengths, mask = self._build_admit(
            admitted, offset=self._prefix_len if prefixed else 0
        )
        self.lengths = new_lengths.copy()
        self.cache, logits, greedy = self.engine.prefill(
            self.cache, ids, new_lengths, slot_mask=mask, with_tokens=True,
            prefix=self._prefix if prefixed else None,
        )
        if all(r.sampling.temperature <= 0 for _, r in admitted):
            # Greedy admissions read the in-program argmax — no extra
            # host sync for sampling.
            arr = np.asarray(greedy)
            tokens = {slot_id: int(arr[slot_id]) for slot_id, _ in admitted}
        else:
            tokens = self._sample_rows(logits, admitted)
        for slot_id, request in admitted:
            request.output.append(tokens[slot_id])
            self.next_tokens[slot_id] = tokens[slot_id]
            hit_eos = (
                request.eos_token_id is not None
                and tokens[slot_id] == request.eos_token_id
            )
            # A prompt that already fills the cache leaves no room to decode:
            # the prefill's token is the one and only emission.
            if (
                hit_eos
                or self.lengths[slot_id] >= self.engine.max_seq
                or len(request.output) >= request.max_new_tokens
            ):
                self._finish(slot_id, request)

    def _admit(self) -> None:
        """Per-step mode admission: one masked prefill call per group
        (prefix-implanted requests, then plain ones)."""
        admitted = self._assign_slots()
        for prefixed in (True, False):
            group = [a for a in admitted if a[1].use_prefix == prefixed]
            if group:
                self._prefill_group(group, prefixed)

    def _sample_rows(self, logits, pairs) -> dict[int, int]:
        """Sample next tokens for the given (slot, request) pairs with ONE
        device call per distinct SamplingParams (per-step mode only; serve
        mode samples per-slot inside the device program)."""
        by_params: dict[SamplingParams, list[int]] = {}
        for slot_id, request in pairs:
            by_params.setdefault(request.sampling, []).append(slot_id)
        out: dict[int, int] = {}
        for params, slot_ids in by_params.items():
            self.rng, step_rng = jax.random.split(self.rng)
            toks = np.asarray(sample(logits, step_rng, params))
            for slot_id in slot_ids:
                out[slot_id] = int(toks[slot_id])
        return out

    def _finish_request(self, request: Request) -> None:
        """Mark complete without touching the slot table (the serve path owns
        slot reuse: a slot may already hold its planned next occupant)."""
        request.done = True
        request.t_finished = time.monotonic()
        self.completed.append(request)
        logger.debug("request %d finished", request.request_id)

    def _finish(self, slot_id: int, request: Request) -> None:
        self._finish_request(request)
        self.slots[slot_id] = None

    # ── serve mode (chunk > 1): one device program, one sync per round ───

    def _admit_kwargs(self, admitted, with_budgets: bool) -> dict:
        """serve_chunk admission kwargs (narrow or full masked)."""
        if (
            self.narrow_admit
            and self.engine.mesh is None  # mesh engines: full admission
            and len(admitted) <= self.engine.max_batch // 2
        ):
            ids, lengths, slots = self._build_admit_narrow(admitted)
            kw = dict(admit_ids=ids, admit_lengths=lengths, admit_slots=slots)
        else:
            ids, lengths, mask = self._build_admit(admitted)
            kw = dict(admit_ids=ids, admit_lengths=lengths, admit_mask=mask)
        if with_budgets:
            budgets = np.zeros((self.engine.max_batch,), np.int32)
            for slot_id, request in admitted:
                budgets[slot_id] = request.max_new_tokens - len(request.output)
            kw["admit_budgets"] = budgets
        return kw

    def _slot_arrays(self, occupant: dict[int, "Request | None"]):
        """(eos, sampling arrays, variant) rows for the given occupancy."""
        B = self.engine.max_batch
        eos = np.full((B,), -1, np.int32)
        params_list = []
        for s in range(B):
            request = occupant.get(s)
            params_list.append(
                request.sampling if request is not None else SamplingParams()
            )
            if request is not None and request.eos_token_id is not None:
                eos[s] = request.eos_token_id
        arrays, variant = batch_sampling_arrays(params_list)
        self._variant = tuple(a or b for a, b in zip(self._variant, variant))
        return eos, arrays

    def _step_serve(self) -> list[Request]:
        """One pipelined serving group with PLANNED admissions.

        The previous pipeline admitted only at group boundaries, so a slot whose request
        finished in round 1 of a 4-round group idled ~3 rounds × chunk steps
        — with request lifetimes of 2-3 rounds that idling was the dominant
        lost term. Completion time is PREDICTABLE from budgets alone: a slot
        with remaining budget b is guaranteed done after ceil(b/chunk)
        rounds (EOS and cache capacity only finish EARLIER, and admitting
        into an already-frozen slot is exactly the normal admission case).
        So the scheduler plans future-round admissions on the host, and
        every continuation round can carry its own admission prefill — all
        dispatched from the device-resident carry BEFORE any blob is read,
        preserving the pipelining that hides the per-round host sync.
        """
        admitted = self._assign_slots()
        prefixed = [a for a in admitted if a[1].use_prefix]
        if prefixed:
            # Prefix-implanted admissions run as their own masked prefill
            # call (one extra device round-trip per round WITH such
            # admissions) — the serve program folds only plain admissions.
            self._prefill_group(prefixed, prefixed=True)
            admitted = [
                a for a in admitted
                if not a[1].use_prefix and not a[1].done
            ]
        occupied = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not occupied:
            return self._drain_completed()

        B = self.engine.max_batch
        chunk = self.chunk
        active = np.array([s is not None for s in self.slots])
        budgets = np.zeros((B,), np.int32)
        for slot_id, request in occupied:
            budgets[slot_id] = request.max_new_tokens - len(request.output)
        occupant: dict[int, Request] = dict(occupied)
        eos, arrays = self._slot_arrays(occupant)

        admit_kw = self._admit_kwargs(admitted, with_budgets=False) if admitted else {}
        self.rng, step_rng = jax.random.split(self.rng)
        self.cache, blob, carry = self.engine.serve_chunk(
            self.cache, self.next_tokens, steps=chunk, active=active,
            budgets=budgets, eos=eos, sampling_arrays=arrays,
            variant=self._variant, rng=step_rng, **admit_kw,
        )
        blobs = [blob]
        admits_per_round: list[dict[int, Request]] = [dict(admitted)]
        occupant_per_round: list[dict[int, Request]] = [dict(occupant)]

        # Guaranteed-remaining emissions per slot (upper bound; EOS/capacity
        # can only finish earlier, which is safe for planned reuse).
        admitted0 = {s for s, _ in admitted}
        pred_rem = {
            s: int(budgets[s]) - (1 if s in admitted0 else 0) - chunk
            for s, _ in occupied
        }

        for _ in range(self.pipeline - 1):
            live = any(rem > 0 for rem in pred_rem.values())
            plain_queue = self.queue and not self.queue[0].use_prefix
            if not live and not plain_queue:
                break
            new_admits: list[tuple[int, Request]] = []
            if plain_queue:
                for s in range(B):
                    if not (self.queue and not self.queue[0].use_prefix):
                        break
                    if s in occupant and pred_rem.get(s, 0) > 0:
                        continue  # still (possibly) running
                    request = self.queue.popleft()
                    request.t_admitted = time.monotonic()
                    occupant[s] = request
                    new_admits.append((s, request))
                    logger.debug(
                        "planned-admitted request %d into slot %d",
                        request.request_id, s,
                    )
            if not live and not new_admits:
                break
            eos, arrays = self._slot_arrays(occupant)
            admit_kw = (
                self._admit_kwargs(new_admits, with_budgets=True)
                if new_admits else {}
            )
            self.rng, step_rng = jax.random.split(self.rng)
            self.cache, blob, carry = self.engine.serve_chunk(
                self.cache, None, steps=chunk, eos=eos,
                sampling_arrays=arrays, variant=self._variant, rng=step_rng,
                carry=carry, **admit_kw,
            )
            blobs.append(blob)
            admits_per_round.append(dict(new_admits))
            occupant_per_round.append(dict(occupant))
            self.stats["planned_admits"] += len(new_admits)
            for s, request in new_admits:
                pred_rem[s] = request.max_new_tokens - 1
            for s in pred_rem:
                pred_rem[s] -= chunk

        self.stats["rounds"] += len(blobs)
        self.stats["slot_steps"] += len(blobs) * B * chunk
        self.stats["admit_rounds"] += sum(1 for a in admits_per_round if a)
        self.stats["boundary_admits"] += len(admits_per_round[0])
        if len(blobs) > 1:
            # ONE host fetch for the whole group: each np.asarray is a host
            # sync with a fixed cost regardless of size, so per-round fetches
            # can make small chunks host-bound. A device-side stack (tiny
            # concat) turns R fetches into one.
            blobs = list(np.asarray(jnp.stack(blobs)))
        for round_idx, blob in enumerate(blobs):
            blob = np.asarray(blob)  # no-op after a stacked fetch
            t0 = blob[:, 0]
            out = blob[:, 1 : 1 + chunk]
            emitted = blob[:, -3]
            done = blob[:, -2].astype(bool)
            self.lengths = blob[:, -1].astype(np.int32)
            self.stats["emitted"] += int(emitted.sum()) + len(
                admits_per_round[round_idx]
            )
            round_admits = admits_per_round[round_idx]
            for slot_id, request in occupant_per_round[round_idx].items():
                if request.done:
                    continue
                if slot_id in round_admits:
                    request.output.append(int(t0[slot_id]))
                request.output.extend(
                    int(t) for t in out[slot_id, : emitted[slot_id]]
                )
                if request.output:
                    self.next_tokens[slot_id] = request.output[-1]
                if done[slot_id]:
                    self._finish_request(request)
        for s in range(B):
            request = occupant.get(s)
            self.slots[s] = (
                request if request is not None and not request.done else None
            )
        return self._drain_completed()

    # ── per-step mode (chunk == 1): the reference-shaped loop ────────────

    def step(self) -> list[Request]:
        """One scheduler iteration: admit, decode, collect finished requests."""
        if self.chunk > 1:
            return self._step_serve()

        self._admit()
        active_mask = np.array([s is not None for s in self.slots])
        if not active_mask.any():
            return self._drain_completed()

        self.cache, logits = self.engine.decode(
            self.cache, self.next_tokens, active=active_mask
        )
        occupied = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        tokens = self._sample_rows(logits, occupied)

        for slot_id, request in occupied:
            token = tokens[slot_id]
            request.output.append(token)
            self.next_tokens[slot_id] = token
            self.lengths[slot_id] = min(
                int(self.lengths[slot_id]) + 1, self.engine.max_seq
            )
            hit_eos = request.eos_token_id is not None and token == request.eos_token_id
            out_of_cache = int(self.lengths[slot_id]) >= self.engine.max_seq
            if hit_eos or out_of_cache or len(request.output) >= request.max_new_tokens:
                self._finish(slot_id, request)

        return self._drain_completed()

    def _drain_completed(self) -> list[Request]:
        out, self.completed = self.completed, []
        return out

    def run(self) -> list[Request]:
        """Run until all submitted requests complete; returns them in finish order."""
        finished: list[Request] = []
        while self.has_work:
            finished.extend(self.step())
        return finished

"""Inference engine: jit'd prefill + decode over a static KV cache.

The serving runtime the reference outsources to ONNX Runtime (SURVEY.md §2B):
all shapes are static — prefill compiles once per (batch, padded length)
bucket, decode compiles exactly once — so XLA sees two programs total and the
decode loop runs back-to-back device steps. Ragged batches are handled with
per-sequence lengths: pad-token K/V writes land in slots that a sentinel in
``kv_positions`` keeps masked until a real token overwrites them.

Works with fp or quantized params (the Linear sites dispatch through
``ops.quantized_matmul``) and fp or int8/int4 KV cache.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.engine.kv_cache import (
    KVCacheConfig,
    init_cache,
    read_kv,
    read_kv_quantized,
    write_kv,
    write_kv_rows,
    write_kv_window,
)
from onnx_quantize_tpu.engine.sampling import SamplingParams, sample, sample_batch

logger = get_logger(__name__)

__all__ = ["InferenceEngine", "prepare_kernel_scales"]

_FAR = 1 << 30  # kv_positions sentinel: always masked


def prepare_kernel_scales(params):
    """Pre-bake packed GROUP-quantized scale/zp into the W4 kernel's padded
    (G_pad/2, 2, N) group-pair layout.

    The per-call pad/convert/reshape prep in ``matmul_w4._expand_scales`` is
    memory-expanding, so XLA does not hoist it out of the decode scan: it
    would add several fused ops per site per step. Baked once here, the
    wrapper's pair-layout passthrough skips the prep;
    ``ops.reference.weight_qparams_2d`` slices the layout back for the jnp
    oracle, so either layout is valid anywhere a QTensor flows."""
    import dataclasses

    from onnx_quantize_tpu.core.enums import QuantizationStrategy
    from onnx_quantize_tpu.nn.qtensor import QTensor
    from onnx_quantize_tpu.ops.kernels.matmul_w4 import _expand_scales

    def prep(leaf):
        if not (
            isinstance(leaf, QTensor)
            and leaf.meta.packed
            and leaf.meta.strat == QuantizationStrategy.GROUP
        ):
            return leaf
        if getattr(leaf.data, "ndim", 2) != 2:
            # Stacked MoE expert weights (leading expert axis): bake BEFORE
            # stacking (stack_moe_experts docstring) — per-expert slices of an
            # already-baked stack keep the kernel layout.
            return leaf
        if getattr(leaf.scale, "ndim", None) == 3:
            return leaf  # already baked
        _, N = leaf.meta.shape
        gs = leaf.meta.pack_group
        G_pad = 2 * leaf.data.shape[0] // gs
        s, z = _expand_scales(leaf, G_pad, N)
        return dataclasses.replace(
            leaf,
            scale=s.reshape(G_pad // 2, 2, N),
            zero_point=z.reshape(G_pad // 2, 2, N),
        )

    return jax.tree.map(prep, params, is_leaf=lambda x: isinstance(x, QTensor))


class InferenceEngine:
    """Jit'd prefill/decode engine; single-chip or tensor+data parallel.

    With ``mesh`` set (axes ``(data, model)``), every step runs as ONE
    ``shard_map`` program over the mesh: the batch shards over ``data`` and
    the model runs the Megatron TP schedule over ``model`` — per-device
    quantized matmuls on local weight shards, one psum per column->row pair,
    a single logits all-gather (see ``parallel/tp.py``). The model must
    implement ``tp_localize`` (Gemma3 does).
    """

    def __init__(
        self,
        model,
        params,
        max_batch: int = 8,
        max_seq: int = 2048,
        kv_quant: bool | str = False,
        dtype=jnp.float32,
        mesh=None,
        data_axis: str = "data",
        model_axis: str = "model",
    ):
        cfg = model.cfg
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.dtype = dtype
        self.mesh = mesh
        # kv_quant: False | True/"int8" | "int4" (packed nibbles, half the
        # cache bytes again — see kv_cache.py).
        if kv_quant in (False, None):
            kv_bits = 8
            kv_quant = False
        elif kv_quant in (True, "int8"):
            kv_bits = 8
            kv_quant = True
        elif kv_quant == "int4":
            kv_bits = 4
            kv_quant = True
        else:
            raise ValueError(
                f"kv_quant must be False, True/'int8', or 'int4', got {kv_quant!r}"
            )
        self.cache_cfg = KVCacheConfig(
            num_layers=cfg.num_layers,
            batch=max_batch,
            max_seq=max_seq,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            quantized=kv_quant,
            bits=kv_bits,
            dtype=dtype,
        )
        if mesh is None:
            self._exec_model = model
            # Bake packed-weight scales into the kernel layout once (the TP
            # path keeps logical layouts — its sharding specs are built per
            # logical shape).
            self.params = prepare_kernel_scales(params)
            self._prefill_jit = jax.jit(self._prefill_impl, donate_argnums=(1,))
            self._prefix_prefill_jit = jax.jit(
                self._prefix_prefill_impl, donate_argnums=(1,)
            )
            self._decode_jit = jax.jit(self._decode_impl, donate_argnums=(1,))
            self._decode_multi_jit = jax.jit(
                self._decode_multi_impl, donate_argnums=(1,), static_argnums=(4, 5, 7)
            )
            self._score_jit = jax.jit(self._score_impl, donate_argnums=(1,))
            # serve_chunk: static (steps, variant) — positions 11, 12.
            self._serve_jit = jax.jit(
                self._serve_impl, donate_argnums=(1,), static_argnums=(11, 12)
            )
        else:
            from onnx_quantize_tpu.parallel.tp import build_param_specs, localize_params

            self._data_axis, self._model_axis = data_axis, model_axis
            tp = mesh.shape[model_axis]
            dp = mesh.shape[data_axis]
            if max_batch % dp != 0:
                raise ValueError(f"max_batch={max_batch} not divisible by data={dp}")
            self._exec_model, rules = model.tp_localize(tp, axis=model_axis)
            params = localize_params(params, rules, tp)
            self._param_specs = build_param_specs(params, rules, axis=model_axis)
            shardings = jax.tree.map(
                lambda s: NamedSharding(mesh, s), self._param_specs
            )
            self.params = jax.device_put(params, shardings)
            # tp_localize divides num_kv_heads when the KV heads shard, and
            # sets it to 1 under GQA replicate-slice (1 < kv < tp). Either
            # way each device caches only its local heads; under slice the
            # global cache array holds tp entries (duplicated across devices
            # sharing a KV head — HBM for generality, tp/kv_heads overhead).
            local_kv = self._exec_model.cfg.num_kv_heads
            kv_sharded = local_kv != cfg.num_kv_heads
            if kv_sharded and local_kv * tp != cfg.num_kv_heads:
                import dataclasses

                self.cache_cfg = dataclasses.replace(
                    self.cache_cfg, num_kv_heads=local_kv * tp
                )
            self._cache_specs = self._make_cache_specs(kv_sharded)
            d = self._data_axis
            self._prefill_jit = jax.jit(
                shard_map(
                    self._prefill_impl, mesh=mesh,
                    in_specs=(self._param_specs, self._cache_specs,
                              P(d, None), P(d), P(d)),
                    out_specs=(self._cache_specs, P(d, None), P(d)),
                    check_vma=False,
                ),
                donate_argnums=(1,),
            )
            self._decode_jit = jax.jit(
                shard_map(
                    self._decode_impl, mesh=mesh,
                    in_specs=(self._param_specs, self._cache_specs, P(d), P(d)),
                    out_specs=(self._cache_specs, P(d, None)),
                    check_vma=False,
                ),
                donate_argnums=(1,),
            )
            self._tp_decode_multi_cache: dict = {}
            self._tp_serve_cache: dict = {}

    def _make_cache_specs(self, kv_sharded: bool):
        """PartitionSpec tree for the KV cache: batch over data; KV heads over
        model when sharded (arrays are (L, B, S, H[, D]))."""
        d, m = self._data_axis, self._model_axis
        h = m if kv_sharded else None
        specs = {"k": P(None, d, None, h, None), "v": P(None, d, None, h, None),
                 "lengths": P(d)}
        if self.cache_cfg.quantized:
            specs["k_scale"] = P(None, d, None, h)
            specs["v_scale"] = P(None, d, None, h)
        return specs

    def _tp_decode_multi_jit(self, steps: int, sampling, eos_token_id):
        """shard_map'd decode_multi, one compiled program per static config."""
        key = (steps, sampling, eos_token_id)
        fn = self._tp_decode_multi_cache.get(key)
        if fn is None:
            d = self._data_axis

            def impl(params, cache, tokens, active, rng):
                return self._decode_multi_impl(
                    params, cache, tokens, active, steps, sampling, rng,
                    eos_token_id,
                )

            fn = jax.jit(
                shard_map(
                    impl, mesh=self.mesh,
                    in_specs=(self._param_specs, self._cache_specs,
                              P(d), P(d), P()),
                    out_specs=(self._cache_specs, P(d, None)),
                    check_vma=False,
                ),
                donate_argnums=(1,),
            )
            self._tp_decode_multi_cache[key] = fn
        return fn

    def new_cache(self) -> dict:
        cache = init_cache(self.cache_cfg)
        if self.mesh is not None:
            cache = jax.device_put(
                cache,
                jax.tree.map(lambda s: NamedSharding(self.mesh, s), self._cache_specs),
            )
        return cache

    # ── model forward with cache ─────────────────────────────────────────

    def _forward(self, params, cache_holder, ids, positions, kv_positions,
                 last_lengths=None, kv_window=None):
        # A quantized cache is always handed over raw: the model runs the
        # scale-folded XLA attend, so int8 K/V never materialize dequantized.
        quantized = self.cache_cfg.quantized

        def kv_write_fn(layer, k, v):
            if kv_window is not None:
                # Contiguous per-row windows (the speculative verify): the
                # general scatter below rewrites cache traffic proportional
                # to S_max for offset windows — use in-place slice updates.
                start, ok = kv_window
                cache_holder["cache"] = write_kv_window(
                    cache_holder["cache"], layer, k, v, start, ok
                )
            else:
                cache_holder["cache"] = write_kv(
                    cache_holder["cache"], layer, k, v, positions
                )
            if quantized:
                return read_kv_quantized(cache_holder["cache"], layer)
            return read_kv(cache_holder["cache"], layer, dtype=self.dtype)

        model = self._exec_model
        if last_lengths is None:
            return model(
                params, ids, positions=positions, kv_write=kv_write_fn,
                kv_positions=kv_positions,
            )
        # Prefill only needs next-token logits: gather the last valid hidden
        # state per row BEFORE the lm_head, so the (T, vocab) projection —
        # ~40% of prefill FLOPs at a 262k vocab — runs at (B, 1) instead.
        hidden = model.hidden_states(
            params, ids, positions=positions, kv_write=kv_write_fn,
            kv_positions=kv_positions,
        )
        h_last = jnp.take_along_axis(
            hidden, (last_lengths - 1)[:, None, None], axis=1
        )  # (B, 1, H)
        logits = model.lm_head(params["lm_head"], h_last)
        if model._tp_gather_logits is not None:
            logits = jax.lax.all_gather(
                logits, model._tp_gather_logits, axis=logits.ndim - 1, tiled=True
            )
        return logits

    def _prefill_impl(self, params, cache, ids, lengths, slot_mask):
        """ids: (B, T_pad) int32; lengths: (B,) true lengths; slot_mask: (B,)
        bool — slots to (re)fill. Unselected slots keep their cache rows, so
        the continuous-batching scheduler can prefill one slot without
        disturbing in-flight sequences (all inside one jit, donation-safe)."""
        B, T = ids.shape
        positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None, :], (B, T))
        slot = jnp.arange(self.max_seq, dtype=jnp.int32)[None, :]
        kv_positions = jnp.where(slot < lengths[:, None], slot, _FAR)

        holder = {"cache": dict(cache)}
        last = self._forward(
            params, holder, ids, positions, kv_positions, last_lengths=lengths
        )[:, 0]  # (B, V)
        new = holder["cache"]
        merged = {}
        for key in new:
            if key == "lengths":
                continue
            # arrays are (L, B, ...): broadcast the slot mask over dim 1.
            shape = [1, B] + [1] * (new[key].ndim - 2)
            merged[key] = jnp.where(slot_mask.reshape(shape), new[key], cache[key])
        merged["lengths"] = jnp.where(slot_mask, lengths, cache["lengths"])
        # Greedy first tokens computed in-program: the serving scheduler uses
        # them directly for temperature-0 admissions, saving one host sync
        # per admission round.
        return merged, last, jnp.argmax(last, axis=-1).astype(jnp.int32)

    def _prefix_prefill_impl(self, params, cache, prefix, ids, lengths,
                             slot_mask):
        """Suffix prefill on top of an implanted KV prefix (prefix caching).

        ``prefix``: dict of (L, P, H, D) K/V (+ (L, P, H) scales) — a shared
        prompt prefix's cache rows (see :meth:`snapshot_prefix`). ``ids``:
        (B, T_pad) SUFFIX tokens; ``lengths``: (B,) absolute totals
        (P + suffix). The prefix rows are broadcast into every row of the
        working cache (the slot-mask merge restores untouched slots), the
        suffix runs at positions P..P+T-1, and only the suffix's forward is
        paid — the TTFT saving for shared system prompts.
        """
        B, T = ids.shape
        P = prefix["k"].shape[1]
        work = dict(cache)
        for key, arr in prefix.items():
            # (L, P, ...) -> (L, B, P, ...) broadcast write at slot offset 0.
            block = jnp.broadcast_to(
                arr[:, None], (arr.shape[0], B) + arr.shape[1:]
            ).astype(work[key].dtype)
            work[key] = jax.lax.dynamic_update_slice(
                work[key], block, (0,) * work[key].ndim
            )

        positions = P + jnp.broadcast_to(
            jnp.arange(T, dtype=jnp.int32)[None, :], (B, T)
        )
        slot = jnp.arange(self.max_seq, dtype=jnp.int32)[None, :]
        kv_positions = jnp.where(slot < lengths[:, None], slot, _FAR)

        holder = {"cache": work}
        # The hidden states cover only the T suffix positions: the last-token
        # gather index is suffix-local (absolute length minus the prefix).
        last = self._forward(
            params, holder, ids, positions, kv_positions,
            last_lengths=lengths - P,
        )[:, 0]
        new = holder["cache"]
        merged = {}
        for key in new:
            if key == "lengths":
                continue
            shape = [1, B] + [1] * (new[key].ndim - 2)
            merged[key] = jnp.where(slot_mask.reshape(shape), new[key], cache[key])
        merged["lengths"] = jnp.where(slot_mask, lengths, cache["lengths"])
        return merged, last, jnp.argmax(last, axis=-1).astype(jnp.int32)

    def _admit_prefill_impl(self, params, cache, ids, lengths, slots):
        """Narrow admission prefill: forward ONLY the A admitted rows.

        The masked full-batch prefill computes all ``max_batch`` rows at
        ``T_pad`` width no matter how few slots are being (re)filled — at
        serving steady state that is the dominant per-round compute (a
        handful of freed slots pays a full (B, T_pad) forward). Here ids are
        (A, T_pad) with A < B: the admitted rows' forward runs at (A, T_pad),
        their K/V scatter into batch slots ``slots`` (A,) int32 via
        :func:`write_kv_rows`, and attention reads the FRESH rows instead of
        the wide cache — through the same quantized-KV attend when the cache
        is int8, so admission logits/tokens are bit-identical to the
        full-batch masked prefill (adding the wide path's exactly-zero
        masked softmax terms changes nothing). Padding rows pass
        ``slots = max_batch`` (scatter mode="drop").

        Returns (cache', logits (A, V), greedy (A,)).
        """
        A, T = ids.shape
        positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None, :], (A, T))
        tcol = jnp.arange(T, dtype=jnp.int32)[None, :]
        kv_positions = jnp.where(tcol < lengths[:, None], tcol, _FAR)

        holder = {"cache": dict(cache)}
        quantized = self.cache_cfg.quantized

        def kv_write_fn(layer, k, v):
            holder["cache"], fresh = write_kv_rows(
                holder["cache"], layer, k, v, positions, slots
            )
            if not quantized and self.cache_cfg.dtype != k.dtype:
                k, v = fresh
                return k.astype(self.dtype), v.astype(self.dtype)
            return fresh

        model = self._exec_model
        hidden = model.hidden_states(
            params, ids, positions=positions, kv_write=kv_write_fn,
            kv_positions=kv_positions,
        )
        h_last = jnp.take_along_axis(
            hidden, (lengths - 1)[:, None, None], axis=1
        )
        logits = model.lm_head(params["lm_head"], h_last)[:, 0]
        new = holder["cache"]
        new["lengths"] = cache["lengths"].at[slots].set(lengths, mode="drop")
        return new, logits, jnp.argmax(logits, axis=-1).astype(jnp.int32)

    def snapshot_prefix(self, cache, row: int, length: int) -> dict:
        """Extract rows [0, length) of slot ``row`` as a reusable KV prefix.

        Returns device arrays shaped (L, length, H, D) (+ scales) suitable
        for :meth:`prefill`'s ``prefix`` argument. Typically taken once from
        a throwaway prefill of the shared system prompt
        (``ContinuousBatchingScheduler.register_prefix`` does exactly that).
        """
        keys = ["k", "v"] + (
            ["k_scale", "v_scale"] if self.cache_cfg.quantized else []
        )
        return {key: cache[key][:, row, :length] for key in keys}

    def _decode_impl(self, params, cache, tokens, active):
        """tokens: (B,) next input token per slot; active: (B,) bool."""
        lengths = cache["lengths"]
        # Sequences at capacity must not advance; their write position equals
        # max_seq, which the KV scatter drops (mode="drop"), so no slot is
        # corrupted and lengths stay put.
        active = jnp.logical_and(active, lengths < self.max_seq)
        # Inactive slots (finished / empty) write to max_seq, which the
        # scatter's mode="drop" discards — their cache rows stay untouched.
        positions = jnp.where(active, lengths, self.max_seq)[:, None]
        ids = tokens[:, None]
        slot = jnp.arange(self.max_seq, dtype=jnp.int32)[None, :]
        kv_positions = jnp.where(
            slot < (lengths + active.astype(jnp.int32))[:, None], slot, _FAR
        )

        holder = {"cache": cache}
        logits = self._forward(params, holder, ids, positions, kv_positions)
        cache = holder["cache"]
        cache["lengths"] = lengths + active.astype(jnp.int32)
        return cache, logits[:, 0]

    def _decode_multi_impl(self, params, cache, tokens, active, steps: int,
                           sampling: SamplingParams | None = None, rng=None,
                           eos_token_id: int | None = None):
        """``steps`` decode iterations inside one program (lax.scan).

        Amortizes per-step host dispatch over the whole scan. Greedy when
        ``sampling`` is None/zero-temp, otherwise samples with a per-step rng split. When ``eos_token_id`` is
        set, a done-mask carried through the scan freezes finished sequences:
        they stop writing KV, their lengths stop advancing, and their output
        is padded with EOS. Returns (cache, tokens (B, steps)).
        """
        rngs = (
            jax.random.split(rng, steps)
            if sampling is not None and sampling.temperature > 0
            else None
        )

        def step(carry, step_rng):
            cache, toks, done = carry
            act = jnp.logical_and(active, jnp.logical_not(done))
            cache, logits = self._decode_impl(params, cache, toks, act)
            if rngs is None:
                next_toks = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            else:
                next_toks = sample(logits, step_rng, sampling)
            if eos_token_id is not None:
                # Pad already-finished slots with EOS, then absorb this
                # step's fresh EOS emissions into the done-mask.
                next_toks = jnp.where(done, eos_token_id, next_toks)
                done = jnp.logical_or(
                    done, jnp.logical_and(act, next_toks == eos_token_id)
                )
            return (cache, next_toks, done), next_toks

        done0 = jnp.zeros(tokens.shape, bool)
        (cache, _, _), out = jax.lax.scan(
            step, (cache, tokens, done0), rngs, length=steps
        )
        return cache, out.T  # (B, steps)

    def _score_impl(self, params, cache, ids, lengths):
        """Teacher-forced NLL *through the decode path* (one program).

        SURVEY §7 hard-part (5): the reference's perplexity tool
        (``/root/reference/tools/perplexity.py:25-83``) scores full forward
        windows, which never touches the KV cache — so KV-quantization error
        is invisible to it. This scan instead prefills exactly one token and
        then feeds the gold tokens one step at a time through
        ``_decode_impl``: every K/V row is written and read through the same
        int8/int4 quantize→dequantize chain generation uses, so the returned
        NLL *includes* the cache quantization error at every past position.

        ids: (B, T) gold tokens; lengths: (B,) true lengths (>=2 to score).
        Returns (cache, nll_sum (B,) f32, count (B,) int32); perplexity =
        exp(sum(nll)/sum(count)).
        """
        B, T = ids.shape
        assert T >= 2, "need at least two tokens to score a prediction"
        cache, logits0, _ = self._prefill_impl(
            params, cache, ids[:, :1], jnp.minimum(lengths, 1),
            jnp.ones((B,), bool),
        )

        def nll_of(logits, tgt, valid):
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            nll = -jnp.take_along_axis(logp, tgt[:, None], axis=-1)[:, 0]
            return jnp.where(valid, nll, 0.0)

        # Prefill's last-token logits predict position 1.
        valid0 = lengths > 1
        nll_sum = nll_of(logits0, ids[:, 1], valid0)
        count = valid0.astype(jnp.int32)
        if T == 2:
            return cache, nll_sum, count

        # Feed token i (1..T-2); its logits predict position i+1. The final
        # token is never fed: its logits have no target and its KV row could
        # not influence any scored step.
        feed = ids[:, 1:T - 1].T       # (T-2, B)
        tgts = ids[:, 2:].T            # (T-2, B)
        idxs = jnp.arange(1, T - 1)

        def step(carry, xs):
            cache, nll_sum, count = carry
            tok, tgt, i = xs
            act = i < lengths
            cache, logits = self._decode_impl(params, cache, tok, act)
            valid = (i + 1) < lengths
            nll_sum = nll_sum + nll_of(logits, tgt, valid)
            count = count + valid.astype(jnp.int32)
            return (cache, nll_sum, count), None

        (cache, nll_sum, count), _ = jax.lax.scan(
            step, (cache, nll_sum, count), (feed, tgts, idxs)
        )
        return cache, nll_sum, count

    def _serve_impl(self, params, cache, admit, tokens, done0, budgets, eos,
                    temps, top_ks, top_ps, rng, steps: int,
                    variant: tuple[bool, bool, bool]):
        """ONE serving round as ONE device program: optional masked
        admission prefill, per-slot first-token sampling, then ``steps`` decode iterations with per-slot
        sampling/EOS/budget — and every host-relevant scalar packed into a
        single int32 blob so the scheduler pays exactly one host sync per
        round.

        ``admit``: None or (ids (B, T_pad), lengths (B,), mask (B,)).
        Per-slot arrays: ``done0`` slots already frozen/empty at entry (the
        negation of "active"), ``budgets`` remaining max_new per slot
        (admission's first token counts against it), ``eos`` EOS id or -1,
        ``temps`` / ``top_ks`` / ``top_ps`` the sampler rows. ``variant`` is
        the static (need_temp, need_topk, need_topp) OR over the batch.

        A slot freezes (no KV writes, no length advance, output padded) when
        it emits EOS, exhausts its budget, or hits cache capacity — unlike
        ``_decode_multi_impl``, surplus steps past max_new do NOT advance KV.

        Returns ``(cache, blob, carry)``: ``blob (B, steps + 4) int32`` with
        columns ``[t0, out_0..out_{steps-1}, emitted, done, lengths]``
        (``emitted`` counts valid scan tokens — prefix of ``out``, excluding
        t0), and ``carry = (tokens', done', budgets')`` — the device-resident
        per-slot state that lets the scheduler dispatch a CONTINUATION round
        (admit=None, same sampler arrays) without reading this round's blob
        first: the host sync then hides behind the next round's compute
        (pipelined serving).
        """
        need_temp, need_topk, need_topp = variant

        def samp(logits, r):
            return sample_batch(
                logits, r, temps, top_ks, top_ps,
                need_temp=need_temp, need_topk=need_topk, need_topp=need_topp,
            )

        rngs = jax.random.split(rng, steps + 1)
        eos_on = eos >= 0
        done = done0
        if admit is not None:
            # admit is (ids, lengths, mask|slots) or, with a 4th element,
            # (ids, lengths, mask|slots, new_budgets (B,)): mid-pipeline
            # admission into a slot whose previous occupant's budget is in
            # the device carry — the admitted row's fresh budget overrides it
            # in-program (planned pipelined admission, see scheduler).
            new_budgets = None
            if len(admit) == 4:
                ids, lengths, third, new_budgets = admit
            else:
                ids, lengths, third = admit
            if third.dtype == jnp.bool_:
                # Full-batch masked admission (B-wide arrays, bool slot mask).
                mask = third
                cache, last, _ = self._prefill_impl(
                    params, cache, ids, lengths, mask
                )
                t0 = samp(last, rngs[0])
            else:
                # Narrow admission: (A, T_pad) rows + (A,) slot ids — only
                # the admitted rows' forward is computed (the steady-state
                # serving lever; see _admit_prefill_impl).
                slots = third
                B = tokens.shape[0]
                cache, last_a, greedy_a = self._admit_prefill_impl(
                    params, cache, ids, lengths, slots
                )
                mask = jnp.zeros((B,), bool).at[slots].set(True, mode="drop")
                if need_temp:
                    # categorical noise is POSITIONAL (threefry counters over
                    # the flattened array): to keep sampled tokens
                    # bit-identical to the masked full-batch path, scatter
                    # the A logits rows into their B positions and run the
                    # SAME full-batch sampler (the non-admitted rows' draws
                    # are discarded below, exactly as on the masked path).
                    V = last_a.shape[-1]
                    last_b = jnp.zeros((B, V), last_a.dtype).at[slots].set(
                        last_a, mode="drop"
                    )
                    t0 = samp(last_b, rngs[0])
                else:
                    # Greedy is per-row positional-independent: the A-row
                    # argmax already matches the masked path bit-for-bit.
                    t0 = tokens.at[slots].set(greedy_a, mode="drop")
            tokens = jnp.where(mask, t0, tokens)
            emitted0 = mask.astype(jnp.int32)
            done = jnp.logical_and(done, jnp.logical_not(mask))
            done = jnp.logical_or(done, mask & eos_on & (t0 == eos))
            if new_budgets is not None:
                budgets = jnp.where(mask, new_budgets, budgets)
        else:
            t0 = tokens
            emitted0 = jnp.zeros_like(tokens)
        done = jnp.logical_or(done, emitted0 >= budgets)
        done = jnp.logical_or(done, cache["lengths"] >= self.max_seq)
        active = jnp.logical_not(done)

        def step(carry, step_rng):
            cache, toks, done, emitted = carry
            act = jnp.logical_and(active, jnp.logical_not(done))
            cache, logits = self._decode_impl(params, cache, toks, act)
            nxt = samp(logits, step_rng)
            # Frozen slots re-emit padding (their EOS id, or the previous
            # token when no EOS is set); the host discards it via `emitted`.
            pad = jnp.where(eos_on, jnp.maximum(eos, 0), toks)
            nxt = jnp.where(done, pad, nxt)
            emitted = emitted + act.astype(jnp.int32)
            done = jnp.logical_or(done, act & eos_on & (nxt == eos))
            done = jnp.logical_or(done, emitted0 + emitted >= budgets)
            done = jnp.logical_or(done, cache["lengths"] >= self.max_seq)
            return (cache, nxt, done, emitted), nxt

        emitted_init = jnp.zeros_like(budgets)
        (cache, toks, done, emitted), out = jax.lax.scan(
            step, (cache, tokens, done, emitted_init), rngs[1:], length=steps
        )
        blob = jnp.concatenate(
            [
                t0[:, None],
                out.T,
                emitted[:, None],
                done.astype(jnp.int32)[:, None],
                cache["lengths"][:, None],
            ],
            axis=1,
        ).astype(jnp.int32)
        carry = (toks, done, budgets - emitted0 - emitted)
        return cache, blob, carry

    def _tp_serve_jit(self, steps: int, variant, admit_n: int, t_pad: int):
        """shard_map'd serve round; one compiled program per static config.
        ``admit_n``: 0 = no admission, 3 = (ids, lengths, mask),
        4 = + per-slot admit budgets (planned pipelined admission)."""
        key = (steps, variant, admit_n, t_pad)
        fn = self._tp_serve_cache.get(key)
        if fn is None:
            d = self._data_axis
            admit_specs = None
            if admit_n:
                admit_specs = (P(d, None), P(d), P(d)) + (
                    (P(d),) if admit_n == 4 else ()
                )

            def impl(params, cache, admit, tokens, done0, budgets, eos,
                     temps, top_ks, top_ps, rng):
                return self._serve_impl(
                    params, cache, admit, tokens, done0, budgets, eos,
                    temps, top_ks, top_ps, rng, steps, variant,
                )

            fn = jax.jit(
                shard_map(
                    impl, mesh=self.mesh,
                    in_specs=(self._param_specs, self._cache_specs, admit_specs,
                              P(d), P(d), P(d), P(d), P(d), P(d), P(d), P()),
                    out_specs=(self._cache_specs, P(d, None), (P(d), P(d), P(d))),
                    check_vma=False,
                ),
                donate_argnums=(1,),
            )
            self._tp_serve_cache[key] = fn
        return fn

    # ── public API ───────────────────────────────────────────────────────

    def prefill(self, cache, ids: np.ndarray, lengths: np.ndarray,
                slot_mask: np.ndarray | None = None, with_tokens: bool = False,
                prefix: dict | None = None):
        """Prefill; returns (cache, last_token_logits (B, V)).

        ``slot_mask`` selects which batch slots are written (default: all).
        ``with_tokens=True`` also returns the greedy first tokens (B,)
        computed inside the compiled program (no extra device round-trip).
        With ``prefix`` (a :meth:`snapshot_prefix` dict), ``ids`` are the
        SUFFIX tokens and ``lengths`` the absolute totals (prefix + suffix):
        only the suffix's forward is computed (prefix caching).
        """
        if slot_mask is None:
            slot_mask = np.ones((self.max_batch,), bool)
        if prefix is not None:
            if self.mesh is not None:
                raise NotImplementedError(
                    "prefix caching is single-chip for now (shard the prefix "
                    "rows with the cache specs to extend it)"
                )
            cache, logits, tokens = self._prefix_prefill_jit(
                self.params, cache, prefix, jnp.asarray(ids, jnp.int32),
                jnp.asarray(lengths, jnp.int32), jnp.asarray(slot_mask),
            )
        else:
            cache, logits, tokens = self._prefill_jit(
                self.params, cache, jnp.asarray(ids, jnp.int32),
                jnp.asarray(lengths, jnp.int32), jnp.asarray(slot_mask),
            )
        if with_tokens:
            return cache, logits, tokens
        return cache, logits

    def decode(self, cache, tokens: np.ndarray, active: np.ndarray | None = None):
        if active is None:
            active = np.ones(tokens.shape, bool)
        return self._decode_jit(
            self.params, cache, jnp.asarray(tokens, jnp.int32), jnp.asarray(active)
        )

    def decode_multi(self, cache, tokens: np.ndarray, steps: int,
                     active: np.ndarray | None = None,
                     sampling: SamplingParams | None = None,
                     rng: jax.Array | None = None,
                     eos_token_id: int | None = None):
        """Decode ``steps`` tokens in one device program (greedy or sampled).

        With ``eos_token_id`` set, sequences freeze after emitting EOS (no KV
        writes, no length advance; output padded with EOS).
        Returns (cache, generated (B, steps) int32).
        """
        if active is None:
            active = np.ones(tokens.shape, bool)
        if sampling is not None and sampling.temperature > 0 and rng is None:
            rng = jax.random.key(0)
        if self.mesh is not None:
            fn = self._tp_decode_multi_jit(steps, sampling, eos_token_id)
            if rng is None:
                rng = jax.random.key(0)  # replicated placeholder (greedy path)
            return fn(
                self.params, cache, jnp.asarray(tokens, jnp.int32),
                jnp.asarray(active), rng,
            )
        return self._decode_multi_jit(
            self.params, cache, jnp.asarray(tokens, jnp.int32),
            jnp.asarray(active), steps, sampling, rng, eos_token_id,
        )

    def score_nll(self, ids: np.ndarray, lengths: np.ndarray | None = None):
        """Teacher-forced NLL through the engine's decode path.

        Scores ``ids`` (N, T) by prefilling one token and step-decoding the
        rest, so the result reflects the configured KV-cache quantization
        (``kv_quant``) at every position — the accuracy instrument for
        int8/int4 KV (see :meth:`_score_impl`). Rows are processed in
        ``max_batch`` chunks. Returns (nll_sum (N,), count (N,)) numpy arrays.
        """
        if self.mesh is not None:
            raise NotImplementedError(
                "score_nll is single-chip (shard the score scan with the "
                "decode specs to extend it)"
            )
        ids = np.asarray(ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        N, T = ids.shape
        if T > self.max_seq:
            raise ValueError(f"sequence length {T} exceeds max_seq={self.max_seq}")
        if lengths is None:
            lengths = np.full((N,), T, np.int32)
        lengths = np.asarray(lengths, np.int32)
        nll = np.zeros((N,), np.float32)
        cnt = np.zeros((N,), np.int32)
        for start in range(0, N, self.max_batch):
            rows = slice(start, min(start + self.max_batch, N))
            n = rows.stop - rows.start
            pad = self.max_batch - n
            batch_ids = np.pad(ids[rows], ((0, pad), (0, 0)))
            batch_len = np.pad(lengths[rows], (0, pad))
            _, b_nll, b_cnt = self._score_jit(
                self.params, self.new_cache(), jnp.asarray(batch_ids),
                jnp.asarray(batch_len),
            )
            nll[rows] = np.asarray(b_nll)[:n]
            cnt[rows] = np.asarray(b_cnt)[:n]
        return nll, cnt

    def score_ppl(self, ids: np.ndarray, lengths: np.ndarray | None = None) -> float:
        """Perplexity over ``ids`` via :meth:`score_nll` (decode-path KV)."""
        nll, cnt = self.score_nll(ids, lengths)
        return float(np.exp(nll.sum() / max(int(cnt.sum()), 1)))

    def serve_chunk(self, cache, tokens: np.ndarray | None, steps: int, *,
                    eos: np.ndarray, sampling_arrays,
                    variant: tuple[bool, bool, bool], rng: jax.Array,
                    active: np.ndarray | None = None,
                    budgets: np.ndarray | None = None,
                    carry=None,
                    admit_ids: np.ndarray | None = None,
                    admit_lengths: np.ndarray | None = None,
                    admit_mask: np.ndarray | None = None,
                    admit_slots: np.ndarray | None = None,
                    admit_budgets: np.ndarray | None = None):
        """One serving round in ONE device program (see ``_serve_impl``).

        ``sampling_arrays`` = (temps, top_ks, top_ps) per-slot rows (build
        with ``sampling.batch_sampling_arrays``); ``variant`` their static
        feature flags. Pass ``admit_*`` to fold this round's admissions'
        masked prefill into the same program.

        Per-slot entry state comes from EITHER host arrays (``tokens``,
        ``active``, ``budgets``) OR a ``carry`` returned by the previous
        round — the latter is entirely device-resident, so a continuation
        round can be dispatched BEFORE the previous round's blob is read:
        the scheduler pipelines rounds and the host sync hides behind
        device compute.

        Returns ``(cache, blob, carry)`` with blob (B, steps + 4) int32 =
        [t0, out..., emitted, done, lengths].
        """
        temps, top_ks, top_ps = sampling_arrays
        admit = None
        if admit_ids is not None:
            if admit_slots is not None:
                # Narrow admission: (A, T_pad) rows + slot ids (A,) int32 —
                # only the admitted rows' forward runs (_admit_prefill_impl).
                if self.mesh is not None:
                    raise NotImplementedError(
                        "narrow admission is single-chip; mesh engines use "
                        "the full masked admission"
                    )
                admit = (
                    jnp.asarray(admit_ids, jnp.int32),
                    jnp.asarray(admit_lengths, jnp.int32),
                    jnp.asarray(admit_slots, jnp.int32),
                )
            else:
                admit = (
                    jnp.asarray(admit_ids, jnp.int32),
                    jnp.asarray(admit_lengths, jnp.int32),
                    jnp.asarray(admit_mask),
                )
            if admit_budgets is not None:
                # Planned pipelined admission: the admitted slots' budgets
                # live in the device carry; override them in-program.
                admit = admit + (jnp.asarray(admit_budgets, jnp.int32),)
        if carry is not None:
            toks, done0, budgets_arr = carry
        else:
            toks = jnp.asarray(tokens, jnp.int32)
            done0 = jnp.logical_not(jnp.asarray(active))
            budgets_arr = jnp.asarray(budgets, jnp.int32)
        args = (
            self.params, cache, admit, toks, done0, budgets_arr,
            jnp.asarray(eos, jnp.int32), jnp.asarray(temps, jnp.float32),
            jnp.asarray(top_ks, jnp.int32), jnp.asarray(top_ps, jnp.float32),
            rng,
        )
        if self.mesh is not None:
            t_pad = 0 if admit is None else admit[0].shape[1]
            fn = self._tp_serve_jit(
                steps, variant, 0 if admit is None else len(admit), t_pad
            )
            return fn(*args)
        return self._serve_jit(*args, steps, variant)

    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int = 32,
        sampling: SamplingParams = SamplingParams(),
        eos_token_id: int | None = None,
        rng: jax.Array | None = None,
    ) -> list[list[int]]:
        """Simple batched generation (one prefill + greedy/sampled decode loop)."""
        assert len(prompts) <= self.max_batch
        if rng is None:
            rng = jax.random.key(0)
        B = self.max_batch
        lengths = np.zeros((B,), np.int32)
        T_pad = max(max(len(p) for p in prompts), 1)
        ids = np.zeros((B, T_pad), np.int32)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
            lengths[i] = len(p)
        lengths = np.maximum(lengths, 1)

        cache = self.new_cache()
        cache, logits = self.prefill(cache, ids, lengths)

        outputs: list[list[int]] = [[] for _ in prompts]
        done = np.zeros((B,), bool)
        done[len(prompts):] = True
        for _ in range(max_new_tokens):
            rng, step_rng = jax.random.split(rng)
            tokens = np.asarray(sample(logits, step_rng, sampling))
            for i in range(len(prompts)):
                if not done[i]:
                    outputs[i].append(int(tokens[i]))
                    if eos_token_id is not None and tokens[i] == eos_token_id:
                        done[i] = True
            if done.all():
                break
            cache, logits = self.decode(cache, tokens, active=~done)
        return outputs

"""KV cache with optional int8 / int4 quantization.

The serving-side component the reference delegates to ORT (SURVEY.md §2B,
"inference engine" row): static-shape per-layer K/V buffers sized
``(L, B, S_max, H_kv, D)`` so every decode step reuses one compiled program.

Int8 mode quantizes per (token, head) with a symmetric abs-max scale on write
(``k_scale`` ``(L, B, S_max, H_kv)``) and dequantizes on read — attention math
stays in the model dtype while the cache holds 1 byte/element + scale, a 3.5x
HBM saving over f32 that directly lifts decode throughput (decode is
bandwidth-bound on the cache reads).

Int4 mode (``bits=4``) halves the cache again: ±7 symmetric levels per
(token, head), two values packed per byte along head_dim in a HALVES layout
(byte ``j`` holds ``d=j`` in the low nibble and ``d=j+D/2`` in the high one,
so unpacking is one shift/mask + concat — no interleave). The packed buffer
dtype is uint8, which is also how every consumer DETECTS 4-bit (int8 caches
are int8): the cache pytree stays plain arrays, jit-safe, with no metadata
leaf.

Functional: every write returns a new cache pytree (donated under jit).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

__all__ = ["KVCacheConfig", "QuantizedKV", "init_cache", "write_kv", "read_kv",
           "read_kv_quantized", "pack_nibbles", "unpack_nibbles"]


@dataclasses.dataclass
class QuantizedKV:
    """A layer's int8/int4 K/V cache view, consumed without dequantization.

    The model runs the scale-folded XLA attend on it: K/V enter the einsums
    as raw int casts (which XLA fuses into the dot reads) and the
    per-(token, head) scales apply to the score columns / attention weights —
    no dequantized (B, S, H, D) cache array ever exists. Int4 views hold packed uint8
    (last dim D/2); ``k_ints()``/``v_ints()`` give the int8-valued codes."""

    k: Any  # (B, S, H_kv, D) int8, or (B, S, H_kv, D/2) uint8 packed int4
    v: Any
    k_scale: Any  # (B, S, H_kv) f32
    v_scale: Any

    def k_ints(self):
        return unpack_nibbles(self.k) if self.k.dtype == jnp.uint8 else self.k

    def v_ints(self):
        return unpack_nibbles(self.v) if self.v.dtype == jnp.uint8 else self.v


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    batch: int
    max_seq: int
    num_kv_heads: int
    head_dim: int
    quantized: bool = False  # int8/int4 cache
    bits: int = 8  # 8 or 4 (only read when quantized)
    dtype: Any = jnp.float32


def init_cache(cfg: KVCacheConfig) -> dict:
    shape = (cfg.num_layers, cfg.batch, cfg.max_seq, cfg.num_kv_heads, cfg.head_dim)
    if cfg.quantized:
        if cfg.bits not in (4, 8):
            raise ValueError(f"KV cache bits must be 4 or 8, got {cfg.bits}")
        if cfg.bits == 4:
            if cfg.head_dim % 2:
                raise ValueError("int4 KV cache needs an even head_dim")
            shape = shape[:-1] + (cfg.head_dim // 2,)
        dt = jnp.uint8 if cfg.bits == 4 else jnp.int8
        cache = {
            "k": jnp.zeros(shape, dt),
            "v": jnp.zeros(shape, dt),
            "k_scale": jnp.zeros(shape[:-1], jnp.float32),
            "v_scale": jnp.zeros(shape[:-1], jnp.float32),
        }
    else:
        cache = {"k": jnp.zeros(shape, cfg.dtype), "v": jnp.zeros(shape, cfg.dtype)}
    cache["lengths"] = jnp.zeros((cfg.batch,), jnp.int32)
    return cache


def _quantize_sym(x):
    """Per (token, head) symmetric int8: scale = absmax / 127.

    The division/round run in f32 regardless of the activation dtype — with a
    bf16 stream the 8-bit mantissa would cost ~0.4% extra quantization error.
    """
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=-1)
    scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
    q = jnp.clip(jnp.round(x32 / scale[..., None]), -127, 127).astype(jnp.int8)
    return q, scale


def pack_nibbles(q):
    """Signed codes in [-8, 7], even last dim D -> uint8 (..., D/2), halves
    layout: byte j = (d=j | d=j+D/2 << 4), offset-8 unsigned nibbles."""
    d = q.shape[-1]
    lo = (q[..., : d // 2].astype(jnp.int32) + 8).astype(jnp.uint8)
    hi = (q[..., d // 2:].astype(jnp.int32) + 8).astype(jnp.uint8)
    return lo | (hi << 4)


def unpack_nibbles(b):
    """uint8 (..., D/2) -> int8 codes (..., D) (inverse of pack_nibbles)."""
    lo = (b & 0xF).astype(jnp.int32) - 8
    hi = (b >> 4).astype(jnp.int32) - 8
    return jnp.concatenate([lo, hi], axis=-1).astype(jnp.int8)


def _quantize_sym4(x):
    """Per (token, head) symmetric int4 (±7 levels), packed along head_dim."""
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=-1)
    scale = jnp.where(absmax > 0, absmax / 7.0, 1.0)
    q = jnp.clip(jnp.round(x32 / scale[..., None]), -7, 7)
    return pack_nibbles(q), scale


def _quantize_rows(cache: dict, x):
    """Quantize fresh rows in the cache's own format (int8 vs packed int4)."""
    if cache["k"].dtype == jnp.uint8:
        return _quantize_sym4(x)
    return _quantize_sym(x)


def write_kv(cache: dict, layer: int, k, v, positions) -> dict:
    """Write new K/V rows at per-sequence ``positions`` (B, T) for ``layer``.

    k/v: (B, T, H_kv, D). Returns the updated cache.
    """
    quantized = "k_scale" in cache

    def scatter(buf, rows):
        # buf: (L, B, S, H, D) or (L, B, S, H); rows time-indexed by
        # positions (B, T). ONE scatter straight into the 5D buffer — the
        # earlier slice-out/update/slice-in pattern
        # (``buf.at[layer].set(buf[layer].at[...].set(rows))``) compiled to
        # several times slower writes at the 4B shape.
        # mode="drop": out-of-range positions (sequences at capacity) skip
        # the write instead of clamping onto the last slot.
        B = rows.shape[0]
        batch_idx = jnp.arange(B)[:, None]
        return buf.at[layer, batch_idx, positions].set(
            rows.astype(buf.dtype), mode="drop"
        )

    new = dict(cache)
    if quantized:
        kq, ks = _quantize_rows(cache, k)
        vq, vs = _quantize_rows(cache, v)
        new["k"] = scatter(cache["k"], kq)
        new["v"] = scatter(cache["v"], vq)
        new["k_scale"] = scatter(cache["k_scale"], ks)
        new["v_scale"] = scatter(cache["v_scale"], vs)
    else:
        new["k"] = scatter(cache["k"], k)
        new["v"] = scatter(cache["v"], v)
    return new


def write_kv_rows(cache: dict, layer: int, k, v, positions, slots):
    """Scatter A new rows' K/V into batch slots ``slots`` (A,) at per-row
    ``positions`` (A, T) — the narrow admission prefill's write: only the
    admitted rows' forward is computed, so k/v are (A, T, H, D) with A <
    max_batch. Out-of-range slots or positions drop (padding rows pass
    ``slots = B``). Returns (cache', quantized-or-plain fresh rows) — the
    fresh rows feed the admission's own attention so it reads NOTHING back
    from the wide cache (and, when quantized, attends over the SAME int8
    values the cache now holds, keeping admission tokens bit-identical to
    the full-batch masked prefill)."""
    quantized = "k_scale" in cache

    def scatter(buf, rows):
        A = rows.shape[0]
        row_idx = slots[:, None] * jnp.ones((1, positions.shape[1]), jnp.int32)
        return buf.at[layer, row_idx, positions].set(
            rows.astype(buf.dtype), mode="drop"
        )

    new = dict(cache)
    if quantized:
        kq, ks = _quantize_rows(cache, k)
        vq, vs = _quantize_rows(cache, v)
        new["k"] = scatter(cache["k"], kq)
        new["v"] = scatter(cache["v"], vq)
        new["k_scale"] = scatter(cache["k_scale"], ks)
        new["v_scale"] = scatter(cache["v_scale"], vs)
        fresh = QuantizedKV(k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        new["k"] = scatter(cache["k"], k)
        new["v"] = scatter(cache["v"], v)
        fresh = (k, v)
    return new, fresh


def write_kv_window(cache: dict, layer: int, k, v, start, ok) -> dict:
    """Contiguous-window K/V write at per-row offsets (B rows, T columns).

    ``write_kv``'s general scatter lowers to cache traffic proportional to
    S_max when the (B, T) positions are per-row OFFSET windows (the scatter
    rewrites the cache, not the window). Per-row in-place ``dynamic_update_slice`` costs O(B*T*H*D):
    the same verify drops to decode-step cost.

    ``start``: (B,) int32 window starts; ``ok``: (B,) bool — rows with
    ``ok=False`` keep their window unchanged (the frozen-slot analogue of
    the scatter's mode="drop"; clamped starts never corrupt because the
    old window is blended back).
    """
    quantized = "k_scale" in cache
    B, T = k.shape[:2]
    S = cache["k"].shape[2]
    ok = jnp.logical_and(ok, start + T <= S)

    def upd(buf, rows):
        rows = rows.astype(buf.dtype)
        for b in range(B):  # static: latency-mode batches are small
            s = jnp.clip(start[b], 0, S - T)
            idx = (layer, b, s) + (0,) * (buf.ndim - 3)
            size = (1, 1, T) + buf.shape[3:]
            cur = jax.lax.dynamic_slice(buf, idx, size)
            blend = jnp.where(ok[b], rows[b][None, None], cur)
            buf = jax.lax.dynamic_update_slice(buf, blend, idx)
        return buf

    new = dict(cache)
    if quantized:
        kq, ks = _quantize_rows(cache, k)
        vq, vs = _quantize_rows(cache, v)
        new["k"] = upd(cache["k"], kq)
        new["v"] = upd(cache["v"], vq)
        new["k_scale"] = upd(cache["k_scale"], ks)
        new["v_scale"] = upd(cache["v_scale"], vs)
    else:
        new["k"] = upd(cache["k"], k)
        new["v"] = upd(cache["v"], v)
    return new


def read_kv_quantized(cache: dict, layer: int) -> QuantizedKV:
    """The layer's raw int8 K/V + scales (no dequantization, no HBM copy)."""
    return QuantizedKV(
        k=cache["k"][layer], v=cache["v"][layer],
        k_scale=cache["k_scale"][layer], v_scale=cache["v_scale"][layer],
    )


def read_kv(cache: dict, layer: int, dtype=jnp.float32):
    """Full (B, S_max, H, D) K/V for ``layer``, dequantized if int8/int4."""
    k = cache["k"][layer]
    v = cache["v"][layer]
    if "k_scale" in cache:
        if k.dtype == jnp.uint8:
            k = unpack_nibbles(k)
            v = unpack_nibbles(v)
        k = k.astype(dtype) * cache["k_scale"][layer][..., None]
        v = v.astype(dtype) * cache["v_scale"][layer][..., None]
    return k.astype(dtype), v.astype(dtype)

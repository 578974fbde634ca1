"""Token sampling: greedy, temperature, top-k, top-p — scalar and per-row.

``sample`` applies ONE SamplingParams to the whole batch (the reference-shaped
API). ``sample_batch`` is the serving-path sampler: per-row parameter arrays
so heterogeneous requests sample inside one compiled program. Logits are cast
to f32 at the sampling boundary so a bf16 activation stream never changes sampled tokens or
top-p cutoffs (8-bit-mantissa softmax/cumsum drift).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

__all__ = ["SamplingParams", "sample", "sample_batch", "batch_sampling_arrays"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled


def sample(logits: jnp.ndarray, rng: jax.Array, params: SamplingParams) -> jnp.ndarray:
    """Sample next tokens from (B, V) logits."""
    logits = logits.astype(jnp.float32)
    if params.temperature <= 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    logits = logits / params.temperature
    if params.top_k > 0:
        kth = jnp.sort(logits, axis=-1)[:, -params.top_k][:, None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if params.top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # Keep the smallest prefix with cumulative mass >= top_p.
        cutoff_idx = jnp.sum(cum < params.top_p, axis=-1)
        cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx[:, None], axis=-1)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return jax.random.categorical(rng, logits, axis=-1).astype(jnp.int32)


def batch_sampling_arrays(params_list: list[SamplingParams]):
    """Pack per-slot SamplingParams into (temps, top_ks, top_ps) arrays plus
    the static variant flags ``(need_temp, need_topk, need_topp)``.

    The flags are trace-time switches for ``sample_batch``: they gate whole
    feature blocks so an all-greedy batch compiles to a bare argmax (the
    top-k/top-p machinery sorts a (B, 262k) matrix — never pay it blind)."""
    import numpy as np

    temps = np.array([p.temperature for p in params_list], np.float32)
    top_ks = np.array([p.top_k for p in params_list], np.int32)
    top_ps = np.array([p.top_p for p in params_list], np.float32)
    sampled = temps > 0
    variant = (
        bool(sampled.any()),
        bool((sampled & (top_ks > 0)).any()),
        bool((sampled & (top_ps < 1.0)).any()),
    )
    return (temps, top_ks, top_ps), variant


def sample_batch(
    logits: jnp.ndarray,
    rng: jax.Array | None,
    temps: jnp.ndarray,
    top_ks: jnp.ndarray,
    top_ps: jnp.ndarray,
    *,
    need_temp: bool = True,
    need_topk: bool = True,
    need_topp: bool = True,
) -> jnp.ndarray:
    """Vectorized per-row sampling from (B, V) logits.

    Per-row parameters: ``temps`` (B,) f32 (<= 0 => greedy row), ``top_ks``
    (B,) int32 (0 => disabled), ``top_ps`` (B,) f32 (>= 1 => disabled). Rows
    with disabled features match ``sample``'s semantics exactly (the masks
    reduce to no-ops), so mixed batches need only ONE program.
    """
    logits = logits.astype(jnp.float32)
    greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    if not need_temp:
        return greedy

    x = logits / jnp.maximum(temps, 1e-6)[:, None]
    sorted_desc = None
    if need_topk or need_topp:
        sorted_desc = jnp.sort(x, axis=-1)[:, ::-1]
    if need_topk:
        V = x.shape[-1]
        idx = jnp.clip(top_ks - 1, 0, V - 1)
        kth = jnp.take_along_axis(sorted_desc, idx[:, None], axis=-1)
        on = (top_ks > 0)[:, None]
        x = jnp.where(on & (x < kth), -jnp.inf, x)
        # Re-derive the post-mask descending sort without a second sort:
        # masked entries are exactly the sorted tail below the kth value.
        sorted_desc = jnp.where(on & (sorted_desc < kth), -jnp.inf, sorted_desc)
    if need_topp:
        probs = jax.nn.softmax(sorted_desc, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        cutoff_idx = jnp.sum(cum < top_ps[:, None], axis=-1)
        cutoff = jnp.take_along_axis(sorted_desc, cutoff_idx[:, None], axis=-1)
        x = jnp.where((top_ps < 1.0)[:, None] & (x < cutoff), -jnp.inf, x)
    sampled = jax.random.categorical(rng, x, axis=-1).astype(jnp.int32)
    return jnp.where(temps <= 0.0, greedy, sampled)

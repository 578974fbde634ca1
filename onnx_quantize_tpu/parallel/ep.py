"""Token-sharded expert parallelism: all_to_all dispatch / combine.

The engine's EP path (``fuse_moe_experts`` + ``tp_localize``) keeps
activations replicated across the model axis and psums the combine — ideal
when the batch fits every chip. At data-parallel scale the tokens themselves
shard, and the canonical schedule (GShard / Switch / DeepSeek-MoE) moves
token rows to their experts' devices and back with two ``all_to_all``
collectives over the device interconnect:

  1. route locally (router weights replicated),
  2. pack each token-choice into a (num_experts, capacity) dispatch buffer,
  3. all_to_all: device i's rows for device j's experts swap so each device
     holds (E_local, ep * capacity) rows for ITS experts,
  4. run the local experts (the same stacked site dicts the engine uses —
     fp or quantized, Pallas kernels per shard),
  5. all_to_all back, scatter-add with the routing weights.

``capacity`` is the per-(source device, expert) row budget. ``None`` sizes
it to the worst case (``M_local * top_k`` — no token can ever drop, output
EXACTLY equals the single-device MoE MLP); production configs set
``capacity_factor``-style budgets and accept drops (dropped choices
contribute zero, the standard GShard semantics — renormalization is the
caller's policy). Both behaviors are pinned in
``tests/parallel/test_ep_a2a.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["a2a_moe_mlp"]


def a2a_moe_mlp(x, stacked: dict, top_p, top_i, *, axis: str,
                num_experts: int, activation: str = "silu",
                capacity: int | None = None):
    """Token-sharded MoE MLP over the ``axis`` mesh axis.

    ``x``: (M_local, d) this device's token rows; ``top_p`` / ``top_i``:
    (M_local, k) routing weights / expert ids (global expert numbering);
    ``stacked``: THIS device's local experts as stacked site dicts (leading
    axis ``num_experts / ep``, expert ``g`` global id = ``axis_index * E_local
    + g`` — exactly :func:`models.moe.stack_moe_experts`'s layout sharded on
    its leading axis). Returns (M_local, d) in f32.
    """
    ep = lax.axis_size(axis)
    if num_experts % ep != 0:
        raise ValueError(f"num_experts={num_experts} not divisible by ep={ep}")
    e_local = num_experts // ep
    M, d = x.shape
    k = top_i.shape[-1]
    cap = capacity if capacity is not None else M * k

    flat_e = top_i.reshape(-1)  # (M*k,) global expert per choice
    flat_w = top_p.reshape(-1).astype(jnp.float32)
    tok = jnp.repeat(jnp.arange(M, dtype=jnp.int32), k)

    # Slot of each choice within its expert's capacity: rank among same-
    # expert choices in flat order. Choices past the budget drop (scatter
    # mode="drop" via an out-of-range slot).
    onehot = jax.nn.one_hot(flat_e, num_experts, dtype=jnp.int32)
    rank = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    slot = jnp.where(rank < cap, rank, cap)

    # Dispatch buffer (E, cap, d): row per (expert, slot).
    disp = jnp.zeros((num_experts, cap, d), x.dtype)
    disp = disp.at[flat_e, slot].set(x[tok], mode="drop")

    # all_to_all: (ep, E_local, cap, d) -> each device keeps its experts'
    # rows from EVERY source device: (E_local, ep, cap, d).
    disp = disp.reshape(ep, e_local, cap, d)
    recv = lax.all_to_all(disp, axis, split_axis=0, concat_axis=0, tiled=False)
    # recv: (ep_src, e_local, cap, d) — source-device-major.

    # The expert execution semantics come from the ONE shared definition the
    # engine's MoE module uses (models/gemma3.py) — no fork to desynchronize.
    from onnx_quantize_tpu.models.gemma3 import stacked_expert_mlp

    outs = []
    for g in range(e_local):
        rows = recv[:, g].reshape(ep * cap, d)
        outs.append(stacked_expert_mlp(stacked, g, rows, activation))
    y = jnp.stack(outs).reshape(e_local, ep, cap, d)  # (e_local, ep_src, cap, d)

    # Reverse all_to_all: send each source device its tokens' results back.
    y = jnp.swapaxes(y, 0, 1)  # (ep_src, e_local, cap, d)
    back = lax.all_to_all(y, axis, split_axis=0, concat_axis=0, tiled=False)
    back = back.reshape(num_experts, cap, d)  # this device's choices

    # Combine: gather each choice's row, weight, scatter-add per token.
    got = back[flat_e, jnp.clip(slot, 0, cap - 1)]
    keep = (rank < cap).astype(jnp.float32) * flat_w
    out = jnp.zeros((M, d), jnp.float32)
    out = out.at[tok].add(got.astype(jnp.float32) * keep[:, None])
    return out

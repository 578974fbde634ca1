"""Pipeline parallelism: stage-split decoder execution under ``shard_map``.

The reference has no distributed execution at all (SURVEY.md §2B); the TP
engine covers the tensor axis. This module adds the PIPELINE axis — the
standard GPipe fill/drain schedule expressed the JAX way (the
scaling-book recipe): devices along a ``pipe`` mesh axis each hold a
contiguous stage of decoder layers (stage params are STACKED along a leading
axis and sharded by a plain ``PartitionSpec``, so placement is data layout,
not program logic), microbatches stream through the ring, and the only
cross-device traffic is one activation ``ppermute`` per step, which XLA's
scheduler overlaps with the next microbatch's compute.

Scope: full-sequence scoring/prefill workloads (perplexity evaluation, bulk
scoring) over quantized or fp decoders — the phase where pipelining pays
(deep model, many microbatches amortize the S-1 bubble). Decode-with-cache
is intentionally served by the TP engine instead: at one token per step the
pipeline bubble is pure latency and TP's per-layer collectives are strictly
better on the interconnect.

Requirements: ``num_layers % stages == 0`` and each within-stage position
must have the same static attention flavor across stages (true for all
Llama/Qwen/MoE-convention configs — every layer global — and for Gemma-3
whenever the layers-per-stage is a multiple of ``sliding_pattern``).

Usage::

    stage_params, shared = pipeline_stage_params(model, params, stages=4)
    logits = pp_logits(model, stage_params, shared, ids, mesh,
                       microbatches=8)   # == model(params, ids)
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.nn.qtensor import QTensor

logger = get_logger(__name__)

__all__ = ["pipeline_stage_params", "pp_logits", "make_pipeline_mesh"]


def make_pipeline_mesh(stages: int, devices=None, axis: str = "pipe") -> Mesh:
    if devices is None:
        devices = jax.devices()
    if len(devices) < stages:
        raise ValueError(f"need >= {stages} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:stages]), (axis,))


def _stack_stage_leaves(per_stage: list):
    """Stack one layer-position's param subtree across stages."""

    def is_leaf(x):
        return isinstance(x, QTensor)

    def stack(*leaves):
        if isinstance(leaves[0], QTensor):
            meta = leaves[0].meta
            for qt in leaves[1:]:
                if not isinstance(qt, QTensor) or qt.meta != meta:
                    raise ValueError(
                        "pipeline stages must be quantized identically "
                        "(QTensor metas differ across stages)"
                    )
            children = [qt.tree_flatten()[0] for qt in leaves]
            stacked = tuple(
                None if ch[0] is None else jnp.stack([np.asarray(c) for c in ch])
                for ch in (tuple(c[i] for c in children)
                           for i in range(len(children[0])))
            )
            return QTensor.tree_unflatten(meta, stacked)
        return jnp.stack([np.asarray(x) for x in leaves])

    return jax.tree.map(stack, *per_stage, is_leaf=is_leaf)


def pipeline_stage_params(model, params: dict, stages: int):
    """Split a decoder param tree into (stacked stage params, shared params).

    Stage ``s`` holds layers ``[s*L/S, (s+1)*L/S)``. Every layer-position's
    params are stacked across stages along a new leading axis — sharding that
    axis over the ``pipe`` mesh axis gives each device exactly its stage.
    ``shared`` (embed / final_norm / lm_head) replicates.
    """
    cfg = model.cfg
    L = cfg.num_layers
    if stages < 2:
        raise ValueError("pipeline needs stages >= 2")
    if L % stages != 0:
        raise ValueError(f"num_layers={L} not divisible by stages={stages}")
    per_stage_len = L // stages
    # Static attention flavor must agree across stages per position (the
    # stage program is ONE compiled function run by every device).
    for j in range(per_stage_len):
        flavors = {cfg.is_global_layer(s * per_stage_len + j) for s in range(stages)}
        if len(flavors) != 1:
            raise ValueError(
                f"layer position {j} mixes local/global attention across "
                f"stages (sliding_pattern={cfg.sliding_pattern}); choose "
                "stages so layers-per-stage is a multiple of the pattern"
            )
    stage_tree = {}
    for j in range(per_stage_len):
        per_stage = [
            params[f"layers.{s * per_stage_len + j}"] for s in range(stages)
        ]
        stage_tree[f"pos.{j}"] = _stack_stage_leaves(per_stage)
    shared = {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
    }
    return stage_tree, shared


def _stage_specs(stage_tree, axis: str):
    """PartitionSpec tree: every stacked leaf shards its leading stage axis."""

    def spec(leaf):
        if isinstance(leaf, QTensor):
            children, meta = leaf.tree_flatten()
            return QTensor.tree_unflatten(
                meta, tuple(None if c is None else P(axis) for c in children)
            )
        return P(axis)

    return jax.tree.map(spec, stage_tree,
                        is_leaf=lambda x: isinstance(x, QTensor))


def _unstack_local(tree):
    """Strip the local (length-1) stage axis inside shard_map."""
    return jax.tree.map(lambda a: a[0], tree)


def pp_logits(model, stage_tree, shared, ids, mesh: Mesh, *,
              axis: str = "pipe", microbatches: int | None = None):
    """Full-sequence logits via the GPipe fill/drain schedule.

    ``ids``: (B, T) with ``B % microbatches == 0``. Numerically equal to
    ``model(params, ids)`` (same kernels per shard; f32 residual chain
    unchanged). ``microbatches`` defaults to the stage count.
    """
    from onnx_quantize_tpu.models.gemma3 import make_attention_mask

    cfg = model.cfg
    S = mesh.shape[axis]
    n_mb = microbatches or S
    B, T = ids.shape
    if B % n_mb != 0:
        raise ValueError(f"batch {B} not divisible by microbatches={n_mb}")
    mb = B // n_mb
    per_stage_len = cfg.num_layers // S
    ids_mb = np.asarray(ids, np.int32).reshape(n_mb, mb, T)

    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (mb, T))
    mask_local = make_attention_mask(cfg, positions, positions, is_global=False)
    mask_global = make_attention_mask(cfg, positions, positions, is_global=True)

    def stage_fn(stage_local, shared_p, ids_all):
        stage_params = _unstack_local(stage_local)
        stage = lax.axis_index(axis)
        # Embeddings for every microbatch (cheap gather, replicated) — stage 0
        # consumes microbatch t at schedule step t.
        x_all = model.embed(shared_p["embed"], ids_all)
        if cfg.scale_embeddings:
            x_all = x_all * math.sqrt(cfg.hidden_size)
        x_all = x_all.astype(cfg.jnp_dtype)

        def apply_stage(x):
            for j in range(per_stage_len):
                block = model.blocks[j]  # static flags match across stages
                m = mask_global if block.attn.is_global else mask_local
                x = block(stage_params[f"pos.{j}"], x, positions, m)
            return x

        recv = jnp.zeros((mb, T, cfg.hidden_size), cfg.jnp_dtype)
        done = jnp.zeros((n_mb, mb, T, cfg.hidden_size), cfg.jnp_dtype)
        ring = [(i, (i + 1) % S) for i in range(S)]
        for t in range(n_mb + S - 1):
            mb_idx = min(t, n_mb - 1)
            x_in = jnp.where(stage == 0, x_all[mb_idx], recv)
            y = apply_stage(x_in)
            if t >= S - 1:
                # The LAST stage completed microbatch t-(S-1); other stages'
                # contributions are masked out (psum below keeps one copy).
                upd = jnp.where(stage == S - 1, y, 0)
                done = lax.dynamic_update_slice(
                    done, upd[None], (t - (S - 1), 0, 0, 0)
                )
            recv = lax.ppermute(y, axis, ring)
        # Replicate the completed activations, then run the (fat) lm_head
        # data-parallel over the pipe axis: each stage scores its share of
        # microbatches and one tiled all-gather reassembles.
        done = lax.psum(done, axis)
        if n_mb % S == 0:
            share = n_mb // S
            mine = lax.dynamic_slice_in_dim(done, stage * share, share, axis=0)
            h = model.final_norm(shared_p["final_norm"], mine)
            logits = model.lm_head(shared_p["lm_head"], h)
            logits = lax.all_gather(logits, axis, axis=0, tiled=True)
        else:
            h = model.final_norm(shared_p["final_norm"], done)
            logits = model.lm_head(shared_p["lm_head"], h)
        return logits

    fn = shard_map(
        stage_fn, mesh=mesh,
        in_specs=(_stage_specs(stage_tree, axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    logits = jax.jit(fn)(stage_tree, shared, ids_mb)
    return logits.reshape(B, T, -1)

"""Context parallelism: sequence-sharded scoring with ring attention.

The reference has no distributed execution at all (SURVEY.md §2B); TP covers
the hidden axis and PP the depth axis. This module adds the SEQUENCE axis —
long-context scoring where even one sequence's activations (or the (T, T)
score matrix) exceed a chip. Tokens are sharded over a ``seq`` mesh axis;
every op in the decoder is token-pointwise except attention, which runs as a
**ring**: each device computes its Q/K/V shard, then K/V blocks rotate around
the ring via ``ppermute`` (one hop per step, overlapped with the block's
attention compute by XLA's scheduler) while a streaming (online-softmax)
accumulator folds each visited block into the local queries' output. No
(T, T) score matrix and no gathered K/V ever materialize; per-device memory
is O(T/C).

Two KV modes:

* ``mode="ring"`` — the streaming accumulator above (the Ring Attention
  schedule). Blocks that the causal/sliding-window mask fully hides are
  skipped with ``lax.cond`` (no matmul work — on sliding-window layers almost
  every remote block is skipped). Matches the dense path to f32-accumulation
  tolerance (online softmax renormalizes; it is not bit-identical).
* ``mode="gather"`` — one tiled ``all_gather`` of the (small, GQA) K/V heads,
  then the exact dense attend. Memory O(T) for K/V but activations stay
  sharded; bit-comparable to the single-device path. The right choice when
  Hkv*D is small and T is only moderately long.

Causal load balance: with contiguous shards, the last device's queries see
every block while the first sees one (a 2x average-waste skew). The
``layout="zigzag"`` option gives each device one chunk from the front and the
mirrored chunk from the back of the sequence, equalizing visible blocks per
device per step. Correctness is layout-independent: positions (RoPE + mask)
travel with the tokens, so any permutation whose shards include their own
diagonal block is exact — logits are un-permuted on the way out.

Scope: full-sequence scoring/prefill (perplexity, calibration sweeps, bulk
scoring) on the Gemma3-family decoder (Gemma/Llama/Qwen/MoE configs; MoE
routing is per-token so experts compose with CP unchanged). Decode-with-cache
stays on the TP engine: at one query token a ring is all latency, no win.

Usage::

    mesh = make_cp_mesh(4)                       # axis "seq"
    logits = cp_logits(model, params, ids, mesh) # == model(params, ids)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from onnx_quantize_tpu._logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "make_cp_mesh",
    "make_cp_tp_mesh",
    "cp_localize",
    "cp_logits",
    "cp_tp_logits",
    "make_cp_forward",
    "zigzag_permutation",
    "cp_attend",
]


def make_cp_mesh(shards: int, devices=None, axis: str = "seq") -> Mesh:
    if devices is None:
        devices = jax.devices()
    if len(devices) < shards:
        raise ValueError(f"need >= {shards} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:shards]), (axis,))


def zigzag_permutation(T: int, shards: int) -> np.ndarray:
    """Token order such that contiguous shard c holds chunks (c, 2C-1-c).

    Balances the causal ring: every device owns equally many "early" and
    "late" tokens, so the number of non-skipped blocks per ring step is the
    same on every device instead of ramping 1..C across the ring.
    """
    if T % (2 * shards) != 0:
        raise ValueError(f"zigzag needs T % (2*shards) == 0, got T={T}, shards={shards}")
    h = T // (2 * shards)
    chunks = np.arange(T).reshape(2 * shards, h)
    order = []
    for c in range(shards):
        order.append(chunks[c])
        order.append(chunks[2 * shards - 1 - c])
    return np.concatenate(order)


def _ring_attend(q, k, v, q_pos, *, cfg, is_global: bool, axis: str, size: int):
    """Streaming-softmax ring attention over a sequence-sharded mesh axis.

    q: (B, Tl, Hq, D) local queries (RoPE'd, pre-scaled — `_qkv` output),
    k/v: (B, Tl, Hkv, D) local keys/values, q_pos: (B, Tl) GLOBAL positions.
    Returns (B, Tl, Hq, D) f32.

    Invariant: step 0 attends the device's OWN block, whose diagonal is
    always visible (kv_pos == q_pos passes both the causal and the window
    test), so the running max is real before any fully-masked block can
    contribute exp(0) artifacts and the final l is never zero.
    """
    from onnx_quantize_tpu.models.gemma3 import make_attention_valid

    B, Tl, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Tl, Hkv, G, D)
    m = jnp.full((B, Hkv, G, Tl), -1e30, jnp.float32)
    l = jnp.zeros((B, Hkv, G, Tl), jnp.float32)
    acc = jnp.zeros((B, Hkv, G, Tl, D), jnp.float32)
    kv_pos = q_pos
    ring = [(i, (i + 1) % size) for i in range(size)]
    for step in range(size):
        # Both the additive mask and the skip predicate derive from the same
        # boolean tensor, so any future additive-bias variants (ALiBi, soft
        # caps) cannot desync visibility from the skip decision.
        valid = make_attention_valid(cfg, q_pos, kv_pos, is_global)  # (B,1,Tl,Sl)
        mask = jnp.where(valid, 0.0, -1e30).astype(jnp.float32)

        def update(m, l, acc, k=k, v=v, mask=mask):
            # Same dtype chain as the dense path (gemma3.py:270-275): scores
            # in q.dtype on the tensor cores, f32 softmax pieces, probs in v.dtype.
            s = jnp.einsum("btkgh,bskh->bkgts", qg, k.astype(qg.dtype))
            s = s.astype(jnp.float32) + mask[:, :, None]
            m_new = jnp.maximum(m, jnp.max(s, axis=-1))
            p = jnp.exp(s - m_new[..., None])
            corr = jnp.exp(m - m_new)
            l_new = l * corr + jnp.sum(p, axis=-1)
            pv = jnp.einsum("bkgts,bskh->bkgth", p.astype(v.dtype), v)
            return m_new, l_new, acc * corr[..., None] + pv.astype(jnp.float32)

        # Skip fully-masked blocks (devices diverge freely between the
        # ppermutes): on causal layers this is the past-only half of the
        # ring; on sliding-window layers it is almost every remote block.
        any_visible = jnp.any(valid)
        m, l, acc = lax.cond(
            any_visible, update, lambda m, l, acc: (m, l, acc), m, l, acc
        )
        if step < size - 1:
            k, v, kv_pos = lax.ppermute((k, v, kv_pos), axis, ring)
    out = acc / l[..., None]  # (B, Hkv, G, Tl, D)
    return out.transpose(0, 3, 1, 2, 4).reshape(B, Tl, Hq, D)


def _gather_attend(q, k, v, q_pos, *, cfg, is_global: bool, axis: str):
    """All-gather-KV sequence parallelism: exact dense attend on full K/V."""
    from onnx_quantize_tpu.models.gemma3 import make_attention_mask

    B, Tl, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    kf = lax.all_gather(k, axis, axis=1, tiled=True)
    vf = lax.all_gather(v, axis, axis=1, tiled=True)
    kv_pos = lax.all_gather(q_pos, axis, axis=1, tiled=True)
    mask = make_attention_mask(cfg, q_pos, kv_pos, is_global)
    qg = q.reshape(B, Tl, Hkv, G, D)
    s = jnp.einsum("btkgh,bskh->bkgts", qg, kf.astype(qg.dtype))
    s = s.astype(jnp.float32) + mask[:, :, None]
    probs = jax.nn.softmax(s, axis=-1).astype(vf.dtype)
    out = jnp.einsum("bkgts,bskh->btkgh", probs, vf)
    return out.reshape(B, Tl, Hq, D)


def cp_attend(q, k, v, q_pos, *, cfg, is_global: bool, axis: str, size: int,
              mode: str = "ring"):
    """Dispatch for the Gemma3Attention context-parallel hook (`cp_spec`)."""
    if mode == "ring":
        return _ring_attend(q, k, v, q_pos, cfg=cfg, is_global=is_global,
                            axis=axis, size=size)
    if mode == "gather":
        return _gather_attend(q, k, v, q_pos, cfg=cfg, is_global=is_global,
                              axis=axis)
    raise ValueError(f"unknown cp mode {mode!r} (expected 'ring' or 'gather')")


def cp_localize(model, *, axis: str = "seq", size: int, mode: str = "ring"):
    """Fresh model instance whose attention runs the CP ring.

    Params are untouched (fully replicated): CP is an execution layout, not a
    weight layout. The returned model only behaves differently inside
    ``shard_map`` over ``axis``; its structure (and therefore the params tree
    it accepts) is identical to ``model``'s.
    """
    if not hasattr(model, "blocks"):
        raise ValueError("context parallelism supports the Gemma3-family decoder")
    if mode not in ("ring", "gather"):
        raise ValueError(f"unknown cp mode {mode!r}")
    local = type(model)(model.cfg)
    for block in local.blocks:
        block.attn.cp_spec = (axis, size, mode)
    return local


def make_cp_forward(model, mesh: Mesh, seq_len: int, *, axis: str = "seq",
                    mode: str = "ring", layout: str = "contiguous"):
    """One reusable jitted CP forward for fixed-length sequences.

    Returns ``forward(params, ids) -> logits`` where ``ids`` is (B, seq_len);
    the shard_map program compiles ONCE and is reused across calls (the
    repeated-window pattern — perplexity sweeps, calibration batches).
    """
    C = mesh.shape[axis]
    if seq_len % C != 0:
        raise ValueError(f"seq len {seq_len} not divisible by cp shards {C}")
    if layout == "zigzag":
        perm = zigzag_permutation(seq_len, C)
    elif layout == "contiguous":
        perm = np.arange(seq_len)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    inv = np.argsort(perm)
    perm_j = jnp.asarray(perm, jnp.int32)

    local = cp_localize(model, axis=axis, size=C, mode=mode)

    def fwd(p, ids_loc, pos_loc):
        return local(p, ids_loc, positions=pos_loc)

    fn = jax.jit(shard_map(
        fwd, mesh=mesh,
        in_specs=(P(), P(None, axis), P(None, axis)),
        out_specs=P(None, axis),
        check_vma=False,
    ))

    def forward(params, ids):
        B, T = ids.shape
        if T != seq_len:
            raise ValueError(f"expected seq len {seq_len}, got {T}")
        ids_p = jnp.asarray(ids, jnp.int32)[:, perm_j]
        positions = jnp.broadcast_to(perm_j[None, :], (B, T))
        return fn(params, ids_p, positions)[:, inv]

    return forward


def cp_logits(model, params, ids, mesh: Mesh, *, axis: str = "seq",
              mode: str = "ring", layout: str = "contiguous"):
    """Full-sequence logits with tokens sharded over ``axis``.

    Numerically equal to ``model(params, ids)`` (exact for ``mode="gather"``;
    f32-accumulation-tolerance for ``mode="ring"`` — online softmax).
    ``layout="zigzag"`` balances causal work across the ring (needs
    ``T % (2 * shards) == 0``); ``"contiguous"`` shards ``T`` in order.
    """
    forward = make_cp_forward(
        model, mesh, ids.shape[1], axis=axis, mode=mode, layout=layout
    )
    return forward(params, ids)


def make_cp_tp_mesh(seq_shards: int, tp: int, devices=None,
                    seq_axis: str = "seq", model_axis: str = "model") -> Mesh:
    """(seq x model) 2D mesh: ring hops ride one axis, TP psums the other."""
    if devices is None:
        devices = jax.devices()
    n = seq_shards * tp
    if len(devices) < n:
        raise ValueError(f"need >= {n} devices, have {len(devices)}")
    grid = np.asarray(devices[:n]).reshape(seq_shards, tp)
    return Mesh(grid, (seq_axis, model_axis))


def cp_tp_logits(model, params, ids, mesh: Mesh, *, seq_axis: str = "seq",
                 model_axis: str = "model", mode: str = "ring",
                 layout: str = "contiguous"):
    """2D-parallel scoring: ring attention over ``seq`` x Megatron TP over
    ``model`` in ONE shard_map program.

    Tokens shard the seq axis (K/V ring over local heads); weights shard the
    model axis per ``Gemma3.tp_localize``'s rules (column/row projections,
    one psum per pair, vocab-sharded embedding, single logits all-gather).
    The two collective families never mix: ppermute hops ride the seq
    submesh, psums/all-gathers the model submesh. Numerically equal to the
    single-device forward (same tolerances as ``cp_logits``).
    """
    from onnx_quantize_tpu.parallel.tp import build_param_specs, localize_params

    C = mesh.shape[seq_axis]
    tp = mesh.shape[model_axis]
    B, T = ids.shape
    if T % C != 0:
        raise ValueError(f"seq len {T} not divisible by cp shards {C}")
    if layout == "zigzag":
        perm = zigzag_permutation(T, C)
    elif layout == "contiguous":
        perm = np.arange(T)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    inv = np.argsort(perm)

    local, rules = model.tp_localize(tp, axis=model_axis)
    for block in local.blocks:
        block.attn.cp_spec = (seq_axis, C, mode)
    lparams = localize_params(params, rules, tp)
    pspecs = build_param_specs(lparams, rules, axis=model_axis)

    ids_p = jnp.asarray(ids, jnp.int32)[:, perm]
    positions = jnp.broadcast_to(jnp.asarray(perm, jnp.int32)[None, :], (B, T))

    def fwd(p, ids_loc, pos_loc):
        return local(p, ids_loc, positions=pos_loc)

    fn = jax.jit(shard_map(
        fwd, mesh=mesh,
        in_specs=(pspecs, P(None, seq_axis), P(None, seq_axis)),
        out_specs=P(None, seq_axis),
        check_vma=False,
    ))
    return fn(lparams, ids_p, positions)[:, inv]

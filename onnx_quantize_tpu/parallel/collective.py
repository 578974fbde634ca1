"""Overlapped-collective quantized matmuls (ppermute-pipelined).

The explicit latency-hiding schedules from the scaling-book recipe that
SURVEY.md §2B lists for the TP build ("all-gather/reduce-scatter overlapped
with quantized matmuls via shard_map + ppermute pipelining"):

* :func:`allgather_matmul` — column-parallel matmul whose activations arrive
  M-sharded (sequence-parallel residual stream): instead of materializing
  ``all_gather(x)`` before the dot, each of the ``tp`` pipeline steps runs
  the local Pallas kernel on the row block currently held while the next
  block rides the interconnect via ``ppermute``. XLA's scheduler overlaps the permute
  with the dot (no data dependency), so the collective hides behind compute.
* :func:`matmul_reduce_scatter` — row-parallel matmul that produces an
  M-sharded sum instead of a replicated ``psum``: the partial-sum accumulator
  ring-shifts while the next block's add is computed.

Together they form the sequence-parallel Megatron pair: ``x`` enters and
leaves M-sharded, activations between the pair stay N-sharded, and the only
cross-device traffic is the two pipelined rings — strictly less bandwidth
than the all-gather + psum of the plain schedule (each ring moves
``(tp-1)/tp`` of one activation, vs a full activation each for AG and
AR ≈ 2 rings).

The reference has no distributed execution at all (SURVEY §2B: its backend
abstraction is the ORT ExecutionProvider enum); these schedules are the
The JAX counterpart of what NCCL-based frameworks hand-schedule.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from onnx_quantize_tpu.nn.qtensor import QTensor

__all__ = ["allgather_matmul", "matmul_reduce_scatter", "sequence_parallel_pair"]


def _local_qt(qt: QTensor, shards: int, kind: str) -> "QTensor":
    K, N = qt.meta.shape
    shape = (K, N // shards) if kind == "column" else (K // shards, N)
    return dataclasses.replace(qt, meta=dataclasses.replace(qt.meta, shape=shape))


def _scale_spec(scale, axis, kind):
    if getattr(scale, "ndim", 0) == 0:
        return P()
    if scale.ndim == 1:
        return P(axis) if kind == "column" else P()
    return P(None, axis) if kind == "column" else P(axis, None)


def _ring_perm(tp: int, fwd: bool = True):
    if fwd:
        return [(i, (i + 1) % tp) for i in range(tp)]
    return [(i, (i - 1) % tp) for i in range(tp)]


def _ag_matmul_local(x_loc, qt_loc, axis: str):
    """Per-device body: pipelined all-gather(x) @ W_local.

    ``x_loc``: (M/tp, K) — this device's row block. Returns (M, N/tp).
    """
    from onnx_quantize_tpu.ops import quantized_matmul

    tp = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    m_blk = x_loc.shape[0]
    n_loc = qt_loc.meta.shape[1]

    out = jnp.zeros((m_blk * tp, n_loc), jnp.float32)
    cur = x_loc
    for step in range(tp):
        # After `step` backward ring shifts this device holds the block that
        # started on device (idx + step) — compute its output rows while the
        # next shift is in flight.
        y = quantized_matmul(cur, qt_loc, None)
        row = ((idx + step) % tp) * m_blk
        out = lax.dynamic_update_slice(out, y.astype(out.dtype), (row, 0))
        if step + 1 < tp:
            cur = lax.ppermute(cur, axis, _ring_perm(tp, fwd=False))
    return out


def _matmul_rs_local(h_loc, qt_loc, axis: str):
    """Per-device body: (h @ W_local) reduce-scattered over rows.

    ``h_loc``: (M, K/tp). Returns (M/tp, N) — this device's summed row block.
    """
    from onnx_quantize_tpu.ops import quantized_matmul

    tp = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    y = quantized_matmul(h_loc, qt_loc, None).astype(jnp.float32)
    m_blk = y.shape[0] // tp

    def blk(i):
        return lax.dynamic_slice(y, ((i % tp) * m_blk, 0), (m_blk, y.shape[1]))

    # Ring accumulation. Invariant: at step ``s`` the accumulator residing on
    # device ``d`` carries block ``b = d - 1 - s`` (mod tp) — it was created
    # on device ``b + 1`` and rides the forward ring picking up each device's
    # partial, landing fully-summed on its owner after ``tp - 1`` hops
    # (``b + 1 + (tp-1) = b`` mod tp).
    acc = blk(idx - 1)
    for step in range(1, tp):
        acc = lax.ppermute(acc, axis, _ring_perm(tp, fwd=True))
        acc = acc + blk(idx - 1 - step)
    return acc


def allgather_matmul(x, qt: QTensor, mesh: Mesh, *, axis: str = "model"):
    """Column-parallel matmul from an M-sharded ``x`` (M, K).

    Returns the (M, N)-shaped result N-sharded over ``axis`` (spec
    ``P(axis_M?)``): out is (M, N/tp) per device, replicated rows. Logical
    output spec: ``P(None, axis)``.
    """
    shards = mesh.shape[axis]
    qt_loc_meta = _local_qt(qt, shards, "column")

    def per_device(x_loc, data, scale, zp):
        qt_loc = dataclasses.replace(
            qt_loc_meta, data=data, scale=scale, zero_point=zp
        )
        return _ag_matmul_local(x_loc, qt_loc, axis)

    return shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis, None), P(None, axis),
                  _scale_spec(qt.scale, axis, "column"),
                  _scale_spec(qt.zero_point, axis, "column")),
        out_specs=P(None, axis),
        check_vma=False,
    )(x, qt.data, qt.scale, qt.zero_point)


def matmul_reduce_scatter(h, qt: QTensor, mesh: Mesh, *, axis: str = "model"):
    """Row-parallel matmul producing an M-sharded sum.

    ``h`` is (M, K) K-sharded over ``axis`` (spec ``P(None, axis)``); the
    result is (M, N) M-sharded (spec ``P(axis, None)``).
    """
    shards = mesh.shape[axis]
    qt_loc_meta = _local_qt(qt, shards, "row")

    def per_device(h_loc, data, scale, zp):
        qt_loc = dataclasses.replace(
            qt_loc_meta, data=data, scale=scale, zero_point=zp
        )
        return _matmul_rs_local(h_loc, qt_loc, axis)

    return shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis, None),
                  _scale_spec(qt.scale, axis, "row"),
                  _scale_spec(qt.zero_point, axis, "row")),
        out_specs=P(axis, None),
        check_vma=False,
    )(h, qt.data, qt.scale, qt.zero_point)


def sequence_parallel_pair(x, qt_up: QTensor, qt_down: QTensor, mesh: Mesh,
                           activation=None, *, axis: str = "model"):
    """Sequence-parallel Megatron pair: M-sharded in, M-sharded out.

    ``x`` (M, K) M-sharded → pipelined AG + column matmul → activation
    (N-sharded, local) → row matmul + pipelined RS → (M, N_out) M-sharded.
    One program; both collectives ride the ring overlapped with the local
    Pallas kernels.
    """
    shards = mesh.shape[axis]
    up_meta = _local_qt(qt_up, shards, "column")
    down_meta = _local_qt(qt_down, shards, "row")

    def per_device(x_loc, d_up, s_up, z_up, d_dn, s_dn, z_dn):
        up_loc = dataclasses.replace(up_meta, data=d_up, scale=s_up, zero_point=z_up)
        dn_loc = dataclasses.replace(down_meta, data=d_dn, scale=s_dn, zero_point=z_dn)
        h = _ag_matmul_local(x_loc, up_loc, axis)
        if activation is not None:
            h = activation(h)
        return _matmul_rs_local(h.astype(x_loc.dtype), dn_loc, axis)

    return shard_map(
        per_device,
        mesh=mesh,
        in_specs=(
            P(axis, None),
            P(None, axis), _scale_spec(qt_up.scale, axis, "column"),
            _scale_spec(qt_up.zero_point, axis, "column"),
            P(axis, None), _scale_spec(qt_down.scale, axis, "row"),
            _scale_spec(qt_down.zero_point, axis, "row"),
        ),
        out_specs=P(axis, None),
        check_vma=False,
    )(x, qt_up.data, qt_up.scale, qt_up.zero_point,
      qt_down.data, qt_down.scale, qt_down.zero_point)

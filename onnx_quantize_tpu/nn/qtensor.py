"""QTensor: the quantized-weight pytree leaf.

The JAX analogue of the reference's quantized initializer triple
(``W_q``, ``scale``, ``zero_point`` emitted at ``qrules/_common.py:126-144``)
*plus* the execution spec the reference encodes in its choice of qfunction
(``qfunctions/_qdq/qmatmul.py:9-173``): format, activation quant modes, and the
static activation qparams.

Layout is kernel-first (SURVEY.md §2B): weights keep the logical ``(K, N)``
orientation with ``N`` (out features) on the lane axis; group scales are
``(n_groups, N)`` so a K-tile broadcasts one scale row. 4-bit weights use
*group-pair* nibble packing: the low nibble of packed row ``p*gs + r`` holds
logical row ``(2p)*gs + r`` (scale group ``2p``) and the high nibble holds
``(2p+1)*gs + r`` (group ``2p+1``). Unpacking is therefore two masked shifts
and NO sublane interleave — the Pallas kernel turns one packed ``(gs, bn)``
tile into two dequantized ``(gs, bn)`` tiles that feed two tensor-core dots against
contiguous ``x`` column chunks. Non-group strategies use one virtual group
pair spanning the two K-halves. This deliberately differs from ORT's
MatMulNBits blob layout (``qrules/_common.py:65-123``) — parity is semantic,
not byte-level.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy

__all__ = ["QTensorMeta", "ActQuantSpec", "QTensor", "QBias", "make_qtensor"]


@dataclasses.dataclass(frozen=True)
class ActQuantSpec:
    """Static description of one activation quantization (input or output)."""

    mode: str  # "none" | "static" | "dynamic"
    dtype: str = "uint8"  # QuantType value
    symmetric: bool = False
    reduce_range: bool = False

    @property
    def quant_type(self) -> QuantType:
        return QuantType(self.dtype)


_NO_ACT = ActQuantSpec(mode="none")


@dataclasses.dataclass(frozen=True)
class QTensorMeta:
    """Static (trace-constant) metadata of a quantized weight."""

    quant_type: str  # QuantType value
    strategy: str  # QuantizationStrategy value
    group_size: int  # resolved; -1 for channel/tensor
    symmetric: bool
    reduce_range: bool
    shape: tuple[int, int]  # logical (K, N)
    format: str = "qdq"  # QFormat value
    packed: bool = False  # 4-bit group-pair nibble packing along K
    pack_group: int = 0  # rows per nibble group (gs for GROUP, ceil(K/2) else)
    input_quant: ActQuantSpec = _NO_ACT
    output_quant: ActQuantSpec = _NO_ACT

    @property
    def qt(self) -> QuantType:
        return QuantType(self.quant_type)

    @property
    def strat(self) -> QuantizationStrategy:
        return QuantizationStrategy(self.strategy)

    @property
    def fmt(self) -> QFormat:
        return QFormat(self.format)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QTensor:
    """Quantized weight + qparams + optional static activation qparams.

    Children (traced): data, scale, zero_point, input/output act scales.
    Aux (static): :class:`QTensorMeta`.
    """

    data: Any  # (K, N) int8/uint8 or (ceil(K/2), N) uint8 when packed
    scale: Any  # scalar | (N,) | (n_groups, N)
    zero_point: Any  # same shape family as scale (float for HQQ)
    meta: QTensorMeta
    input_scale: Any = None
    input_zero_point: Any = None
    output_scale: Any = None
    output_zero_point: Any = None

    def tree_flatten(self):
        children = (
            self.data, self.scale, self.zero_point,
            self.input_scale, self.input_zero_point,
            self.output_scale, self.output_zero_point,
        )
        return children, self.meta

    @classmethod
    def tree_unflatten(cls, meta, children):
        data, scale, zp, is_, izp, os_, ozp = children
        return cls(data, scale, zp, meta, is_, izp, os_, ozp)

    @property
    def shape(self) -> tuple[int, int]:
        return self.meta.shape


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QBias:
    """Quantized bias vector (per-tensor), dequantized at execution.

    QDQ Gemm: RTN per-tensor in the weight dtype (``gemm_to_qgemm.py:47-62``).
    QLinear Gemm: int32 with ``scale = x_scale * w_scale`` (``rtn.py:112-138``).
    """

    data: Any  # (N,)
    scale: Any
    zero_point: Any
    quant_type: str

    def tree_flatten(self):
        return (self.data, self.scale, self.zero_point), self.quant_type

    @classmethod
    def tree_unflatten(cls, quant_type, children):
        return cls(*children, quant_type)

    def dequantize(self):
        return (
            jnp.asarray(self.data, jnp.float32) - jnp.asarray(self.zero_point, jnp.float32)
        ) * jnp.asarray(self.scale, jnp.float32)


def pack_layout(K: int, strategy: QuantizationStrategy, group_size: int):
    """Group-pair packing geometry: (rows_per_group, padded_group_count)."""
    if strategy == QuantizationStrategy.GROUP and group_size and group_size > 0:
        gs = min(group_size, K)
    else:
        gs = (K + 1) // 2
    n_groups = -(-K // gs)
    if n_groups % 2 == 1:
        n_groups += 1
    return gs, n_groups


def _pack_group_pairs(q: np.ndarray, gs: int, n_groups_pad: int) -> np.ndarray:
    """Pack (K, N) 4-bit container values into group-pair nibble layout.

    Packed row ``p*gs + r`` holds logical row ``(2p)*gs + r`` in the low
    nibble and ``(2p+1)*gs + r`` in the high nibble. Logical rows past K are
    zero padding. Large tensors route through the native C++ library when it
    is available (checkpoint-load hot path).
    """
    K, N = q.shape
    if K * N >= 1 << 22:  # ~4M elements: worth the native call
        from onnx_quantize_tpu import native

        packed = native.pack_group_pairs(np.asarray(q, dtype=np.int8), gs, n_groups_pad)
        if packed is not None:
            return packed
    K_pad = n_groups_pad * gs
    u = q.astype(np.int32)
    u = np.where(u < 0, u + 16, u).astype(np.uint8)
    if K_pad != K:
        u = np.concatenate([u, np.zeros((K_pad - K, N), dtype=np.uint8)], axis=0)
    u = u.reshape(n_groups_pad // 2, 2, gs, N)
    return ((u[:, 0] & 0x0F) | ((u[:, 1] & 0x0F) << 4)).reshape(K_pad // 2, N)


def unpack_k_pairs(data: jnp.ndarray, K: int, signed: bool, pack_group: int) -> jnp.ndarray:
    """Unpack group-pair nibble layout back to (K, N) container values (jnp)."""
    half_rows, N = data.shape
    gs = pack_group
    pairs = half_rows // gs
    d = data.reshape(pairs, gs, N)
    low = (d & 0x0F).astype(jnp.uint8)
    high = ((d >> 4) & 0x0F).astype(jnp.uint8)
    full = jnp.stack([low, high], axis=1).reshape(2 * half_rows, N)[:K]
    if signed:
        s = full.astype(jnp.int8)
        return jnp.where(s > 7, s - 16, s)
    return full


def _layout_scale(scale: np.ndarray, zp: np.ndarray, strategy: QuantizationStrategy,
                  K: int, N: int):
    """Convert algorithm-layout scale/zp to the kernel layout.

    Algorithms return: scalar (tensor), (N,) (channel), or (N * n_groups, 1)
    (group, row-major over out channels). The kernel layout wants (n_groups, N).
    """
    scale = np.asarray(scale)
    zp = np.asarray(zp)
    if strategy == QuantizationStrategy.GROUP:
        n_groups = scale.size // N
        scale = scale.reshape(N, n_groups).T.copy()
        zp = zp.reshape(N, n_groups).T.copy()
    return scale, zp


def make_qtensor(
    q_weight: np.ndarray,
    scale: np.ndarray,
    zero_point: np.ndarray,
    *,
    quant_type: QuantType,
    strategy: QuantizationStrategy,
    group_size: int,
    symmetric: bool,
    reduce_range: bool,
    fmt: QFormat = QFormat.QDQ,
    input_quant: ActQuantSpec = _NO_ACT,
    output_quant: ActQuantSpec = _NO_ACT,
    input_scale=None,
    input_zero_point=None,
    output_scale=None,
    output_zero_point=None,
) -> QTensor:
    """Build a QTensor from algorithm outputs (``(K, N)`` q-weight + qparams)."""
    K, N = q_weight.shape
    scale, zero_point = _layout_scale(scale, zero_point, strategy, K, N)

    packed = quant_type.bitwidth == 4
    if packed:
        gs, n_groups_pad = pack_layout(K, strategy, group_size)
        data = _pack_group_pairs(np.asarray(q_weight), gs, n_groups_pad)
    else:
        gs = 0
        data = np.asarray(q_weight)

    meta = QTensorMeta(
        quant_type=quant_type.value,
        strategy=strategy.value,
        group_size=group_size if group_size else -1,
        symmetric=symmetric,
        reduce_range=reduce_range,
        shape=(K, N),
        format=fmt.value,
        packed=packed,
        pack_group=gs,
        input_quant=input_quant,
        output_quant=output_quant,
    )
    return QTensor(
        data=jnp.asarray(data),
        scale=jnp.asarray(scale),
        zero_point=jnp.asarray(zero_point),
        meta=meta,
        input_scale=None if input_scale is None else jnp.asarray(input_scale),
        input_zero_point=None if input_zero_point is None else jnp.asarray(input_zero_point),
        output_scale=None if output_scale is None else jnp.asarray(output_scale),
        output_zero_point=None if output_zero_point is None else jnp.asarray(output_zero_point),
    )

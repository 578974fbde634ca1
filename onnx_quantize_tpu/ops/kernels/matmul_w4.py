"""Fused W4 (uint4/int4) grouped dequant-matmul: Pallas on the Triton route.

The MatMulNBits-equivalent decode kernel (SURVEY.md §2B). Packed 4-bit weights
are unpacked in registers: thanks to the group-pair nibble layout (see
``nn/qtensor.py``) one packed ``(bk, bn)`` u8 tile yields the integer tiles of
two consecutive scale groups with one mask and one shift, each feeding a
tensor-core dot against a contiguous ``(bm, bk)`` x chunk. Raw nibbles are
exact in bf16, and the dequant affine moves off the weight tile onto the
``(bm, bn)`` partial product (scale/zp rows are constant within a group):

    x_g @ ((w_g - zp_g) * s_g) == (x_g @ w_g - rowsum(x_g) * zp_g) * s_g

Grid ``(M/bm, N/bn, split_k)``: blocks run in parallel on the SMs, so the
K reduction is a ``fori_loop`` over ``bk``-row tiles inside each block (Triton
pipelines the packed-weight loads over ``num_stages``). Small-N sites split
their group pairs over a third grid axis to fill the card; XLA sums the f32
partials.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.nn.qtensor import QTensor

__all__ = ["w4_dequant_matmul", "w4_supported", "W4Blocks", "pick_blocks"]

# Hopper limits the picker works within (H100 SXM: 132 SMs, 227 KB of shared
# memory a block can use).
NUM_SMS = 132
SMEM_LIMIT = 227 * 1024
# Grid blocks per SM the picker aims for at decode.
BLOCKS_PER_SM = 4


def _w4_kernel(x_ref, w_ref, s_ref, z_ref, o_ref, *, gs, bk, signed, n_tiles,
               compute_dtype):
    # x_ref (bm, 2*pps*gs); w_ref (pps*gs, bn) u8; s_ref/z_ref (pps, 2, bn)
    # f32; o_ref (bm, bn) f32: this split's partial.
    sub = gs // bk
    bm, bn = o_ref.shape
    # f32 operands: HIGHEST keeps the Triton dot in IEEE f32 (its default
    # is TF32); bf16 operands are unaffected.
    prec = jax.lax.Precision.HIGHEST

    def body(t, acc):
        if sub == 1:
            p, r = t, 0
        else:  # t >= 0, so truncating div/rem are floor div/mod
            p = jax.lax.div(t, sub)
            r = jax.lax.rem(t, sub) * bk
        w = w_ref[pl.ds(p * gs + r, bk), :].astype(jnp.int32)
        low = w & 0x0F
        high = w >> 4
        if signed:
            low = (low ^ 8) - 8
            high = (high ^ 8) - 8
        xl = x_ref[:, pl.ds(2 * p * gs + r, bk)]
        xh = x_ref[:, pl.ds((2 * p + 1) * gs + r, bk)]
        dot_l = jnp.dot(xl, low.astype(compute_dtype), precision=prec,
                        preferred_element_type=jnp.float32)
        dot_h = jnp.dot(xh, high.astype(compute_dtype), precision=prec,
                        preferred_element_type=jnp.float32)
        xs_l = jnp.sum(xl.astype(jnp.float32), axis=1)[:, None]
        xs_h = jnp.sum(xh.astype(jnp.float32), axis=1)[:, None]
        s_l = s_ref[p, 0, :][None, :]
        s_h = s_ref[p, 1, :][None, :]
        z_l = z_ref[p, 0, :][None, :]
        z_h = z_ref[p, 1, :][None, :]
        return acc + (dot_l - xs_l * z_l) * s_l + (dot_h - xs_h * z_h) * s_h

    o_ref[...] = jax.lax.fori_loop(0, n_tiles, body,
                                   jnp.zeros((bm, bn), jnp.float32))


@dataclasses.dataclass(frozen=True)
class W4Blocks:
    """Launch geometry of one W4 call."""

    bm: int  # rows per block (power of two, >= 16 for the tensor cores)
    bn: int  # output columns per block (power of two)
    bk: int  # packed rows per loop step (power of two dividing gs)
    split_k: int  # grid splits of the group pairs (divides n_pairs)
    num_warps: int
    num_stages: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _largest_pow2_divisor(n: int, cap: int) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def smem_bytes(blocks: W4Blocks, x_itemsize: int) -> int:
    """Shared memory the Triton pipeline needs for one block: ``num_stages``
    buffered copies of the packed tile, the two x chunks and the scale/zp
    rows, plus the two unpacked weight operands staged for the dot."""
    b = blocks
    per_stage = b.bk * b.bn + 2 * b.bm * b.bk * x_itemsize + 4 * b.bn * 4
    operands = 2 * b.bk * b.bn * x_itemsize
    return b.num_stages * per_stage + operands


def pick_blocks(M: int, N: int, gs: int, n_pairs: int, x_itemsize: int) -> W4Blocks:
    """Launch geometry for an ``(M, 2*n_pairs*gs) @ (.., N)`` W4 call.

    Decode is bound by how many packed-weight loads are in flight, not by
    the work per block: on the H100 the fastest decode geometry at every
    Gemma-3 1B site was ``bn = 64`` with the group pairs split over the grid
    until it holds ``BLOCKS_PER_SM`` blocks per SM, even at the cost of f32
    partials as large as the packed weights (``chip_smoke.py`` and PERF.md).
    Then the deepest ``bk`` (up to 128 rows) and pipeline (4..2 stages) that
    fit the shared memory of one block."""
    bm = min(64, max(16, _pow2_at_least(M)))
    m_blocks = -(-M // bm)
    target = BLOCKS_PER_SM * NUM_SMS
    widths = [c for c in (64, 32) if N % c == 0]
    bn = widths[0] if widths else 32
    split = 1
    for d in range(1, n_pairs + 1):
        if n_pairs % d == 0:
            split = d
            if m_blocks * (N // bn) * d >= target:
                break
    bk = _largest_pow2_divisor(gs, 128)
    while True:
        for stages in (4, 3, 2):
            cfg = W4Blocks(bm, bn, bk, split, 4, stages)
            if smem_bytes(cfg, x_itemsize) <= SMEM_LIMIT:
                return cfg
        if bk > 16:
            bk //= 2
        elif bn > 32:
            bn //= 2
        else:
            return cfg


def _pad_axis(a, axis, to):
    pad = (-a.shape[axis]) % to
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return jnp.pad(a, widths)


@functools.partial(
    jax.jit, static_argnames=("gs", "signed", "blocks", "interpret")
)
def _w4_call(x2d, data, scales, zps, *, gs, signed, blocks: W4Blocks, interpret):
    M_pad, K_pad = x2d.shape
    half_rows, N = data.shape
    b = blocks
    n_pairs = half_rows // gs
    pps = n_pairs // b.split_k
    kernel = functools.partial(
        _w4_kernel, gs=gs, bk=b.bk, signed=signed,
        n_tiles=pps * (gs // b.bk), compute_dtype=x2d.dtype,
    )
    out = pl.pallas_call(
        kernel,
        grid=(M_pad // b.bm, N // b.bn, b.split_k),
        in_specs=[
            pl.BlockSpec((b.bm, 2 * pps * gs), lambda i, j, s: (i, s)),
            pl.BlockSpec((pps * gs, b.bn), lambda i, j, s: (s, j)),
            pl.BlockSpec((pps, 2, b.bn), lambda i, j, s: (s, 0, j)),
            pl.BlockSpec((pps, 2, b.bn), lambda i, j, s: (s, 0, j)),
        ],
        out_specs=pl.BlockSpec((None, b.bm, b.bn), lambda i, j, s: (s, i, j)),
        out_shape=jax.ShapeDtypeStruct((b.split_k, M_pad, N), jnp.float32),
        compiler_params=plgpu.CompilerParams(
            num_warps=b.num_warps, num_stages=b.num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="w4_dequant_matmul",
        cost_estimate=pl.CostEstimate(
            flops=2 * M_pad * K_pad * N,
            bytes_accessed=M_pad * K_pad * x2d.dtype.itemsize + half_rows * N
            + b.split_k * M_pad * N * 4,
            transcendentals=0,
        ),
    )(x2d, data, scales, zps)
    if b.split_k == 1:
        return out[0]
    return jnp.sum(out, axis=0)


def _expand_scales(qt: QTensor, G_pad: int, N: int):
    """Normalize scale/zp to (G_pad, N) f32 rows, padded with (1, 0).

    Inside a decode loop this pad/convert chain is memory-expanding, so XLA
    does not hoist it out of the scan; ``engine.prepare_kernel_scales``
    pre-bakes the (G_pad/2, 2, N) layout at load time, which short-circuits
    here via the pair-layout passthrough."""
    strat = qt.meta.strat
    scale = jnp.asarray(qt.scale, jnp.float32)
    zp = jnp.asarray(qt.zero_point, jnp.float32)
    if scale.ndim == 3:  # already (G_pad/2, 2, N) kernel layout
        return scale.reshape(-1, N), zp.reshape(-1, N)
    if strat == QuantizationStrategy.GROUP:
        G = scale.shape[0]
        if G != G_pad:
            scale = jnp.concatenate(
                [scale, jnp.ones((G_pad - G, N), jnp.float32)], axis=0
            )
            zp = jnp.concatenate([zp, jnp.zeros((G_pad - G, N), jnp.float32)], axis=0)
        return scale, zp
    if strat == QuantizationStrategy.CHANNEL:
        return (
            jnp.broadcast_to(scale[None, :], (G_pad, N)),
            jnp.broadcast_to(zp[None, :], (G_pad, N)),
        )
    return (
        jnp.full((G_pad, N), scale, jnp.float32),
        jnp.full((G_pad, N), zp, jnp.float32),
    )


def w4_dequant_matmul(x, qt: QTensor, *, interpret: bool = False,
                      blocks: W4Blocks | None = None):
    """``x @ dequant(qt)`` with in-kernel nibble unpack; x: (..., K) -> f32.

    The kernel is compiled for the GPU; ``interpret=True`` runs it in the
    Pallas interpreter instead (CPU tests). ``blocks`` overrides the picker.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "w4_dequant_matmul compiles for the GPU only; on "
            f"{jax.default_backend()!r} pass interpret=True explicitly"
        )
    K, N = qt.meta.shape
    gs = qt.meta.pack_group
    half_rows = qt.data.shape[0]
    K_pad = 2 * half_rows
    G_pad = K_pad // gs

    batch_shape = x.shape[:-1]
    M = int(np.prod(batch_shape)) if batch_shape else 1
    if blocks is None:
        blocks = pick_blocks(M, N, gs, G_pad // 2, jnp.dtype(x.dtype).itemsize)
    x2d = x.reshape(M, K)
    x2d = _pad_axis(x2d, 1, K_pad)  # zero rows in the w pad region contribute 0
    x2d = _pad_axis(x2d, 0, blocks.bm)

    scales, zps = _expand_scales(qt, G_pad, N)
    out = _w4_call(
        x2d, jnp.asarray(qt.data),
        scales.reshape(G_pad // 2, 2, N), zps.reshape(G_pad // 2, 2, N),
        gs=gs, signed=qt.meta.qt.is_signed, blocks=blocks, interpret=interpret,
    )
    return out[:M].reshape(*batch_shape, N)


def w4_supported(qt: QTensor) -> bool:
    """Configs the kernel covers: weight-packed QDQ with a group height that
    splits into power-of-two tiles of >= 16 rows (the tensor-core minimum)
    and an output width that tiles into blocks of >= 32 columns."""
    if not qt.meta.packed or qt.meta.fmt != QFormat.QDQ:
        return False
    if getattr(qt.data, "ndim", 2) != 2:
        return False  # stacked MoE experts: per-expert slices are dispatched
    _, N = qt.meta.shape
    return qt.meta.pack_group % 16 == 0 and N % 32 == 0


def w4_entry(x, qt: QTensor, bias, *, interpret: bool = False):
    """One quantized linear site on the kernel: QDQ prologue/epilogue are the
    oracle's own (``ops/reference.py``)."""
    from onnx_quantize_tpu.ops.reference import qdq_epilogue, qdq_prologue

    x = qdq_prologue(x, qt)
    y = w4_dequant_matmul(x, qt, interpret=interpret)
    return qdq_epilogue(y, qt, bias)

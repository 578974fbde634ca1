"""Reference MatMulNBits artifact interop.

The exported blobs must match the layout the reference emits
(``/root/reference/src/onnx_quantize/qrules/_common.py:65-123``): (N, K)
row-major K-groups, low-nibble-first 4-bit packing, per-row zp nibble packing
with the 0x8 pad for odd block counts. Import is tested against blobs built
independently from the published layout (not via our own exporter), so a
shared layout bug cannot cancel out.
"""

import numpy as np
import pytest

from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy
from onnx_quantize_tpu.interop import export_matmul_nbits, import_matmul_nbits
from onnx_quantize_tpu.nn.qtensor import make_qtensor, unpack_k_pairs
from onnx_quantize_tpu.ops.reference import dequantize_weight


def _mk(q, scale, zp, qt_type, gs, symmetric=False):
    return make_qtensor(
        q, scale, zp, quant_type=qt_type, strategy=QuantizationStrategy.GROUP,
        group_size=gs, symmetric=symmetric, reduce_range=False,
    )


def _reference_pack(q, scale, zp, bits, gs):
    """Independent re-statement of the reference blob layout (test oracle)."""
    K, N = q.shape
    n_blocks = K // gs
    rows = q.T.reshape(N * n_blocks, gs).astype(np.uint8)
    if bits == 4:
        blob = (rows[:, ::2] & 0x0F) | ((rows[:, 1::2] & 0x0F) << 4)
    else:
        blob = rows
    blob = blob.reshape(N, n_blocks, gs * bits // 8)
    scales = scale.reshape(n_blocks, N).T.copy()
    zpT = zp.reshape(n_blocks, N).T.astype(np.uint8)
    if bits == 4 and n_blocks > 1:
        if n_blocks % 2 == 1:
            zpT = np.concatenate(
                [zpT, np.full((N, 1), 0x8, np.uint8)], axis=1
            )
        zp_out = (zpT[:, ::2] & 0x0F) | ((zpT[:, 1::2] & 0x0F) << 4)
    else:
        zp_out = zpT
    return blob, scales, zp_out


@pytest.mark.parametrize("bits,gs,K,N", [(4, 16, 64, 8), (4, 32, 96, 16), (8, 16, 48, 8)])
def test_import_from_independent_reference_blob(bits, gs, K, N):
    rng = np.random.default_rng(0)
    n_blocks = K // gs
    q = rng.integers(0, 2**bits, size=(K, N)).astype(np.uint8)
    scale = (0.01 + rng.random((n_blocks, N))).astype(np.float32)
    zp = rng.integers(0, 2**bits, size=(n_blocks, N)).astype(np.uint8)

    blob, scales_ref, zp_ref = _reference_pack(q, scale, zp, bits, gs)
    qt = import_matmul_nbits(
        blob, scales_ref, zp_ref, K=K, N=N, bits=bits, block_size=gs
    )

    # Container values round-trip bit-exactly.
    if bits == 4:
        got = np.asarray(unpack_k_pairs(qt.data, K, False, qt.meta.pack_group))
    else:
        got = np.asarray(qt.data)
    np.testing.assert_array_equal(got, q)

    # Dequantized weights match the layout's affine exactly.
    expect = (q.astype(np.float32) - np.repeat(zp, gs, axis=0)) * np.repeat(
        scale, gs, axis=0
    )
    np.testing.assert_allclose(np.asarray(dequantize_weight(qt)), expect, rtol=1e-6)


def test_odd_block_zp_padding_nibble():
    """Odd n_blocks: the zp pad nibble is 0x8, per the reference example."""
    K, N, gs = 48, 4, 16  # 3 blocks
    rng = np.random.default_rng(1)
    q = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    scale = np.full((3, N), 0.5, np.float32)
    zp = rng.integers(0, 16, size=(3, N)).astype(np.uint8)

    qt = _mk(q, scale.reshape(N * 3, 1, order="F"), zp.reshape(N * 3, 1, order="F"),
             QuantType.QUInt4, gs)
    art = export_matmul_nbits(qt)
    assert art.zero_points.shape == (N, 2)
    # Last byte's high nibble is the 0x8 pad for every row.
    np.testing.assert_array_equal(art.zero_points[:, -1] >> 4, np.full(N, 0x8))
    # Low nibbles reproduce the true zero points.
    np.testing.assert_array_equal(art.zero_points[:, 0] & 0x0F, zp[0])
    np.testing.assert_array_equal(art.zero_points[:, 0] >> 4, zp[1])
    np.testing.assert_array_equal(art.zero_points[:, 1] & 0x0F, zp[2])


@pytest.mark.parametrize("bits,gs,K,N", [(4, 16, 64, 8), (4, 64, 128, 128), (8, 32, 64, 8)])
def test_export_import_round_trip(bits, gs, K, N):
    rng = np.random.default_rng(2)
    n_blocks = K // gs
    qt_type = QuantType.QUInt4 if bits == 4 else QuantType.QUInt8
    q = rng.integers(0, 2**bits, size=(K, N)).astype(np.uint8)
    # Algorithm layout: (N * n_groups, 1) row-major over out channels.
    scale = (0.01 + rng.random((N * n_blocks, 1))).astype(np.float32)
    zp = rng.integers(0, 2**bits, size=(N * n_blocks, 1)).astype(np.float32)

    qt = _mk(q, scale, zp, qt_type, gs)
    art = export_matmul_nbits(qt)
    assert (art.K, art.N, art.bits, art.block_size) == (K, N, bits, gs)
    qt2 = import_matmul_nbits(
        art.data, art.scales, art.zero_points, K=K, N=N, bits=bits, block_size=gs
    )
    np.testing.assert_allclose(
        np.asarray(dequantize_weight(qt2)), np.asarray(dequantize_weight(qt)),
        rtol=1e-6,
    )
    # The blob matches the independent layout oracle byte-for-byte.
    blob, scales_ref, zp_ref = _reference_pack(
        q, np.asarray(qt.scale), np.asarray(qt.zero_point).astype(np.uint8), bits, gs
    )
    np.testing.assert_array_equal(art.data, blob)
    np.testing.assert_array_equal(art.scales, scales_ref)
    np.testing.assert_array_equal(art.zero_points, zp_ref)


def test_float_zp_round_trip():
    """HQQ-style float zero points stay unpacked floats end to end."""
    K, N, gs = 64, 8, 16
    rng = np.random.default_rng(3)
    n_blocks = K // gs
    q = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    scale = (0.01 + rng.random((N * n_blocks, 1))).astype(np.float32)
    zp = (rng.random((N * n_blocks, 1)) * 15).astype(np.float32)

    qt = _mk(q, scale, zp, QuantType.QUInt4, gs)
    art = export_matmul_nbits(qt)
    assert np.issubdtype(art.zero_points.dtype, np.floating)
    assert art.zero_points.shape == (N, n_blocks)
    qt2 = import_matmul_nbits(
        art.data, art.scales, art.zero_points, K=K, N=N, bits=4, block_size=gs
    )
    np.testing.assert_allclose(
        np.asarray(dequantize_weight(qt2)), np.asarray(dequantize_weight(qt)),
        rtol=1e-6,
    )


def test_symmetric_import_without_zp():
    K, N, gs = 32, 8, 16
    rng = np.random.default_rng(4)
    q = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    scale = (0.01 + rng.random((N * 2, 1))).astype(np.float32)
    blob, scales_ref, _ = _reference_pack(
        q, scale.reshape(N, 2).T, np.zeros((2, N), np.uint8), 4, gs
    )
    qt = import_matmul_nbits(blob, scales_ref, None, K=K, N=N, bits=4, block_size=gs)
    assert qt.meta.symmetric
    # Symmetric default zp is the unsigned midpoint (reference rule).
    np.testing.assert_array_equal(np.asarray(qt.zero_point), 8.0)


def test_rejections():
    with pytest.raises(ValueError, match="bits"):
        import_matmul_nbits(
            np.zeros((1, 1, 8), np.uint8), np.ones((1, 1)), None,
            K=16, N=1, bits=5, block_size=16,
        )
    with pytest.raises(ValueError, match="block_size"):
        import_matmul_nbits(
            np.zeros((1, 1, 8), np.uint8), np.ones((1, 1)), None,
            K=20, N=1, bits=4, block_size=16,
        )
    q = np.zeros((16, 8), np.int8)
    qt = make_qtensor(
        q, np.ones((8, 1), np.float32), np.zeros((8, 1), np.float32),
        quant_type=QuantType.QInt4, strategy=QuantizationStrategy.GROUP,
        group_size=16, symmetric=True, reduce_range=False,
    )
    with pytest.raises(ValueError, match="uint4/uint8"):
        export_matmul_nbits(qt)

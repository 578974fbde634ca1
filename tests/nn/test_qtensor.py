"""Direct tests of the QTensor layout layer (``nn/qtensor.py``).

The group-pair nibble layout is the contract shared by the jnp unpack, the
Pallas kernels, and the native C++ library — these tests pin all three against
each other directly (previously only covered indirectly via kernel tests).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy
from onnx_quantize_tpu import native
from onnx_quantize_tpu.nn import qtensor as qt
from onnx_quantize_tpu.nn.qtensor import (
    QBias,
    QTensor,
    make_qtensor,
    pack_layout,
    unpack_k_pairs,
)


# ---------------------------------------------------------------- pack layout

@pytest.mark.parametrize(
    "K, strategy, gs, want_gs, want_groups",
    [
        (256, QuantizationStrategy.GROUP, 64, 64, 4),
        (256, QuantizationStrategy.GROUP, 128, 128, 2),
        # ceil(96/64)=2 groups, already even
        (96, QuantizationStrategy.GROUP, 64, 64, 2),
        # 3 groups -> padded to 4 so pairs close
        (192, QuantizationStrategy.GROUP, 64, 64, 4),
        # gs > K clamps to K, then one group -> padded to 2
        (48, QuantizationStrategy.GROUP, 64, 48, 2),
        # channel strategy: one virtual pair spanning the two K-halves
        (256, QuantizationStrategy.CHANNEL, -1, 128, 2),
        # odd K: virtual gs = ceil(K/2)
        (97, QuantizationStrategy.CHANNEL, -1, 49, 2),
        (2, QuantizationStrategy.TENSOR, -1, 1, 2),
    ],
)
def test_pack_layout_geometry(K, strategy, gs, want_gs, want_groups):
    got_gs, got_groups = pack_layout(K, strategy, gs)
    assert (got_gs, got_groups) == (want_gs, want_groups)
    # invariants: pairs close, padded rows cover K
    assert got_groups % 2 == 0
    assert got_gs * got_groups >= K


# ---------------------------------------------------- pack/unpack round trips

@pytest.mark.parametrize("signed", [False, True], ids=["uint4", "int4"])
@pytest.mark.parametrize(
    "K, strategy, gs",
    [
        (128, QuantizationStrategy.GROUP, 32),
        (96, QuantizationStrategy.GROUP, 32),  # odd group count (padded)
        (130, QuantizationStrategy.CHANNEL, -1),  # K not multiple of pack rows
        (7, QuantizationStrategy.GROUP, 4),  # ragged tail rows
    ],
)
def test_pack_unpack_roundtrip(signed, K, strategy, gs):
    rng = np.random.default_rng(0)
    N = 24
    lo, hi = (-8, 8) if signed else (0, 16)
    q = rng.integers(lo, hi, (K, N)).astype(np.int8)
    pg, n_groups = pack_layout(K, strategy, gs)
    packed = qt._pack_group_pairs(q, pg, n_groups)
    assert packed.dtype == np.uint8
    assert packed.shape == (pg * n_groups // 2, N)
    un = np.asarray(unpack_k_pairs(jnp.asarray(packed), K, signed, pg))
    assert np.array_equal(un, q)


def test_pack_nibble_placement():
    """Low nibble = even scale group, high = odd (the documented contract)."""
    K, N, gs = 8, 3, 4
    q = np.arange(K * N).reshape(K, N).astype(np.int8) % 16
    packed = qt._pack_group_pairs(q, gs, 2)
    # packed row r (r < gs) holds logical rows r (low) and gs + r (high)
    for r in range(gs):
        for n in range(N):
            assert packed[r, n] & 0x0F == q[r, n] & 0x0F
            assert (packed[r, n] >> 4) & 0x0F == q[gs + r, n] & 0x0F


# ------------------------------------------------------------ native parity

needs_native = pytest.mark.skipif(
    native.get_lib() is None, reason="native lib unavailable"
)


@needs_native
@pytest.mark.parametrize(
    "K, N, gs",
    [(128, 64, 32), (96, 24, 32), (130, 16, 65), (512, 256, 128)],
)
def test_native_pack_matches_numpy(K, N, gs):
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    n_groups = -(-K // gs)
    n_groups += n_groups % 2
    native_packed = native.pack_group_pairs(q, gs, n_groups)
    # numpy path (bypass the size-based routing by calling the module helper
    # with the native result already obtained)
    u = np.where(q < 0, q + 16, q).astype(np.uint8)
    K_pad = n_groups * gs
    if K_pad != K:
        u = np.concatenate([u, np.zeros((K_pad - K, N), np.uint8)], axis=0)
    u = u.reshape(n_groups // 2, 2, gs, N)
    ref = ((u[:, 0] & 0x0F) | ((u[:, 1] & 0x0F) << 4)).reshape(K_pad // 2, N)
    assert np.array_equal(native_packed, ref)


@needs_native
@pytest.mark.parametrize("signed", [False, True])
def test_native_unpack_matches_jnp(signed):
    rng = np.random.default_rng(2)
    K, N, gs = 100, 32, 16
    lo, hi = (-8, 8) if signed else (0, 16)
    q = rng.integers(lo, hi, (K, N)).astype(np.int8)
    pg, n_groups = pack_layout(K, QuantizationStrategy.GROUP, gs)
    packed = qt._pack_group_pairs(q, pg, n_groups)
    native_un = native.unpack_group_pairs(packed, K, N, pg, signed)
    jnp_un = np.asarray(unpack_k_pairs(jnp.asarray(packed), K, signed, pg))
    assert np.array_equal(native_un, jnp_un.astype(np.int8))
    assert np.array_equal(native_un, q)


@needs_native
def test_native_minmax_rows_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 513)).astype(np.float32)
    mins, maxs = native.minmax_rows(x)
    np.testing.assert_array_equal(mins, x.min(axis=1))
    np.testing.assert_array_equal(maxs, x.max(axis=1))


# ------------------------------------------------------------- scale layout

def test_group_scale_layout_transposed():
    """Algorithm layout (N * n_groups, 1) -> kernel layout (n_groups, N)."""
    K, N, gs = 64, 8, 16
    n_groups = K // gs
    rng = np.random.default_rng(4)
    q = rng.integers(0, 16, (K, N)).astype(np.int8)
    # row-major over out channels: scale[n * n_groups + g]
    scale = np.arange(N * n_groups, dtype=np.float32).reshape(-1, 1) + 1.0
    zp = np.zeros_like(scale)
    t = make_qtensor(
        q, scale, zp, quant_type=QuantType.QUInt4,
        strategy=QuantizationStrategy.GROUP, group_size=gs,
        symmetric=False, reduce_range=False,
    )
    assert t.scale.shape == (n_groups, N)
    for n in range(N):
        for g in range(n_groups):
            assert float(t.scale[g, n]) == float(scale[n * n_groups + g, 0])


def test_channel_scale_layout_unchanged():
    K, N = 32, 8
    rng = np.random.default_rng(5)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = rng.random(N).astype(np.float32) + 0.1
    t = make_qtensor(
        q, scale, np.zeros(N, np.int8), quant_type=QuantType.QInt8,
        strategy=QuantizationStrategy.CHANNEL, group_size=-1,
        symmetric=True, reduce_range=False,
    )
    assert t.scale.shape == (N,)
    assert not t.meta.packed
    assert np.array_equal(np.asarray(t.data), q)


# ----------------------------------------------------------- pytree contract

def test_qtensor_jit_boundary_roundtrip():
    """QTensor passes through jit as a pytree; meta survives as static aux."""
    rng = np.random.default_rng(6)
    K, N = 32, 16
    q = rng.integers(0, 16, (K, N)).astype(np.int8)
    scale = np.full((N * 2, 1), 0.5, np.float32)
    t = make_qtensor(
        q, scale, np.zeros_like(scale), quant_type=QuantType.QUInt4,
        strategy=QuantizationStrategy.GROUP, group_size=16,
        symmetric=False, reduce_range=False,
    )

    @jax.jit
    def ident(qt_in: QTensor) -> QTensor:
        return qt_in

    out = ident(t)
    assert out.meta == t.meta
    assert np.array_equal(np.asarray(out.data), np.asarray(t.data))
    # meta is hashable static aux (jit would fail otherwise); shape property
    assert out.shape == (K, N)


def test_qtensor_leaves_are_arrays_only():
    """Params-tree invariant: every traced child is an array (or None)."""
    rng = np.random.default_rng(7)
    q = rng.integers(-128, 128, (16, 8)).astype(np.int8)
    t = make_qtensor(
        q, np.float32(0.1), np.int8(0), quant_type=QuantType.QInt8,
        strategy=QuantizationStrategy.TENSOR, group_size=-1,
        symmetric=True, reduce_range=False,
    )
    children, _ = t.tree_flatten()
    for c in children:
        assert c is None or hasattr(c, "dtype")


def test_qbias_dequantize():
    b = QBias(
        data=jnp.asarray([10, 20, 30], jnp.int32),
        scale=jnp.float32(0.5),
        zero_point=jnp.int32(10),
        quant_type="int32",
    )
    np.testing.assert_allclose(np.asarray(b.dequantize()), [0.0, 5.0, 10.0])

import numpy as np
import pytest

from onnx_quantize_tpu import native
from onnx_quantize_tpu.nn.qtensor import _pack_group_pairs, pack_layout
from onnx_quantize_tpu.core.enums import QuantizationStrategy


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable (no C++ toolchain)")
    return lib


@pytest.mark.parametrize("K, N, gs", [(64, 32, 16), (96, 40, 32), (63, 8, 32)])
@pytest.mark.parametrize("signed", [False, True])
def test_native_pack_matches_numpy(rng, lib, K, N, gs, signed):
    lo, hi = (-8, 7) if signed else (0, 15)
    q = rng.integers(lo, hi + 1, size=(K, N)).astype(np.int8)
    n_groups = -(-K // gs)
    if n_groups % 2:
        n_groups += 1
    expected = _numpy_pack(q, gs, n_groups)
    got = native.pack_group_pairs(q, gs, n_groups)
    np.testing.assert_array_equal(got, expected)

    unpacked = native.unpack_group_pairs(got, K, N, gs, signed)
    np.testing.assert_array_equal(unpacked, q)


def _numpy_pack(q, gs, n_groups_pad):
    K, N = q.shape
    K_pad = n_groups_pad * gs
    u = q.astype(np.int32)
    u = np.where(u < 0, u + 16, u).astype(np.uint8)
    if K_pad != K:
        u = np.concatenate([u, np.zeros((K_pad - K, N), np.uint8)], axis=0)
    u = u.reshape(n_groups_pad // 2, 2, gs, N)
    return ((u[:, 0] & 0x0F) | ((u[:, 1] & 0x0F) << 4)).reshape(K_pad // 2, N)


def test_native_pack_agrees_with_qtensor_pack(rng, lib):
    q = rng.integers(0, 16, size=(128, 48)).astype(np.int8)
    gs, n_groups = pack_layout(128, QuantizationStrategy.GROUP, 32)
    np.testing.assert_array_equal(
        native.pack_group_pairs(q, gs, n_groups), _pack_group_pairs(q, gs, n_groups)
    )


def test_native_minmax_rows(rng, lib):
    x = rng.standard_normal((37, 129)).astype(np.float32)
    mins, maxs = native.minmax_rows(x)
    np.testing.assert_allclose(mins, x.min(axis=1), rtol=1e-7)
    np.testing.assert_allclose(maxs, x.max(axis=1), rtol=1e-7)


def test_native_pack_beats_numpy_at_scale(lib):
    """Timing sanity for the vectorized lib: at the
    ~4M-element routing threshold the native pack must not lose to numpy.
    Generous 1.5x slack keeps this stable on loaded CI machines; the typical
    ratio is ~3-10x in native's favor with OpenMP + simd."""
    import time

    rng = np.random.default_rng(0)
    q = rng.integers(0, 16, size=(2048, 4096)).astype(np.int8)  # 8M elements
    gs, n_groups = pack_layout(2048, QuantizationStrategy.GROUP, 64)

    native.pack_group_pairs(q, gs, n_groups)  # warm (thread pool spin-up)
    t0 = time.perf_counter()
    for _ in range(3):
        native.pack_group_pairs(q, gs, n_groups)
    t_native = (time.perf_counter() - t0) / 3

    t0 = time.perf_counter()
    for _ in range(3):
        _numpy_pack(q, gs, n_groups)
    t_numpy = (time.perf_counter() - t0) / 3

    assert t_native < t_numpy * 1.5, (
        f"native pack {t_native*1e3:.1f} ms vs numpy {t_numpy*1e3:.1f} ms"
    )


def test_needs_build_when_missing_or_stale(tmp_path):
    import os

    src = tmp_path / "oqt_native.cpp"
    lib = tmp_path / "liboqt_native.so"
    src.write_text("// source")
    assert native.needs_build(lib, src)  # missing
    lib.write_bytes(b"")
    os.utime(lib, (1_000, 1_000))
    os.utime(src, (2_000, 2_000))
    assert native.needs_build(lib, src)  # older than its source
    os.utime(lib, (3_000, 3_000))
    assert not native.needs_build(lib, src)

"""W4 kernel vs jnp-reference equivalence (Pallas interpreter on the CPU), and
the per-backend, per-shape choice of path.

The analogue of the reference's eager qfunction checks (SURVEY.md §3.5): the
kernel must match the pure-jnp semantics on every config it claims.

Tolerances:
  * f32 x: max abs error <= 1e-4 * max|y|. The kernel folds the dequant affine
    onto the partial product, so only the summation order differs.
  * bf16 x: the oracle on the same bf16 inputs rounds the dequantized weight
    to bf16, while the kernel keeps the raw nibbles (exact in bf16) and
    applies the scale in f32: within 1e-2 of max|y|.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec, make_qtensor
from onnx_quantize_tpu.ops.dispatch import W4_MAX_M, select_path
from onnx_quantize_tpu.ops.kernels.matmul_w4 import W4Blocks, w4_dequant_matmul
from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp

F32_TOL = 1e-4
BF16_TOL = 1e-2


def _qt(rng, K, N, qt_type, strategy, gs, sym=False, fmt=QFormat.QDQ, **extra):
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    q, s, zp = rtn_quantize(w, qt_type, strategy, gs, sym, False)
    return make_qtensor(
        q, s, zp, quant_type=qt_type, strategy=strategy, group_size=gs,
        symmetric=sym, reduce_range=False, fmt=fmt, **extra,
    )


def _check(y, y_ref, tol):
    y, y_ref = np.asarray(y, np.float32), np.asarray(y_ref, np.float32)
    assert y.shape == y_ref.shape
    assert np.abs(y - y_ref).max() <= tol * np.abs(y_ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 8, 33, 64])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("qt_type", [QuantType.QUInt4, QuantType.QInt4])
def test_w4_kernel_matches_reference(rng, qt_type, gs, M, dtype):
    # K = 3 groups: an odd group count, so the pair layout pads K.
    K, N = 3 * gs, 64
    qt = _qt(rng, K, N, qt_type, QuantizationStrategy.GROUP, gs)
    x = jnp.asarray(rng.standard_normal((M, K)), dtype)
    y = w4_dequant_matmul(x, qt, interpret=True)
    y_ref = quantized_matmul_jnp(x, qt)
    _check(y, y_ref, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("K", [64, 640])
@pytest.mark.parametrize("strategy", [
    QuantizationStrategy.CHANNEL, QuantizationStrategy.TENSOR,
])
@pytest.mark.parametrize("qt_type", [QuantType.QUInt4, QuantType.QInt4])
def test_w4_kernel_channel_and_tensor(rng, qt_type, strategy, K):
    # One virtual group pair spans the two K halves (pack_group = K/2): 320
    # rows at K=640 loop over 64-row tiles.
    qt = _qt(rng, K, 128, qt_type, strategy, -1)
    x = rng.standard_normal((6, K)).astype(np.float32)
    _check(w4_dequant_matmul(x, qt, interpret=True), quantized_matmul_jnp(x, qt),
           F32_TOL)


@pytest.mark.parametrize("split_k", [1, 2, 4])
def test_w4_kernel_split_k(rng, split_k):
    """Group pairs split over a grid axis; XLA sums the f32 partials."""
    qt = _qt(rng, 512, 64, QuantType.QUInt4, QuantizationStrategy.GROUP, 32)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    blocks = W4Blocks(bm=16, bn=32, bk=16, split_k=split_k, num_warps=4,
                      num_stages=2)
    _check(w4_dequant_matmul(x, qt, interpret=True, blocks=blocks),
           quantized_matmul_jnp(x, qt), F32_TOL)


def test_w4_kernel_batched_input(rng):
    qt = _qt(rng, 64, 128, QuantType.QUInt4, QuantizationStrategy.GROUP, 16)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    y = np.asarray(w4_dequant_matmul(x, qt, interpret=True))
    assert y.shape == (2, 3, 128)
    _check(y, quantized_matmul_jnp(x, qt), F32_TOL)


def test_w4_kernel_requires_gpu_or_interpret(rng):
    qt = _qt(rng, 64, 128, QuantType.QUInt4, QuantizationStrategy.GROUP, 16)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    with pytest.raises(ValueError, match="interpret=True"):
        w4_dequant_matmul(x, qt)


def test_dispatch_selects_kernels(rng):
    """impl="pallas" (interpreter on the CPU) routes covered configs to the
    kernel, and the result matches the oracle."""
    from onnx_quantize_tpu import ops

    qt = _qt(rng, 64, 128, QuantType.QUInt4, QuantizationStrategy.GROUP, 16)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    assert select_path((4,), qt, backend="cpu", impl="pallas", interpret=True) == "w4"
    ops.set_impl("pallas", interpret=True)
    try:
        y = np.asarray(ops.quantized_matmul(x, qt))
    finally:
        ops.set_impl("auto")
    _check(y, quantized_matmul_jnp(x, qt), F32_TOL)

    # N not tileable -> falls back to jnp.
    qt_small = _qt(rng, 64, 24, QuantType.QUInt4, QuantizationStrategy.GROUP, 16)
    assert select_path((4,), qt_small, backend="cpu", impl="pallas",
                       interpret=True) == "jnp"


def test_w4_predicate_prefill_m_routes_to_jnp(rng):
    """On the GPU, prefill-scale M defers to dequantize-then-dense (the dot is
    compute-bound there); decode steps — (B, 1, K) inputs, ANY batch — stay
    on the kernel, since the dense path would re-materialize the dequantized
    weight every scan step."""
    qt = _qt(rng, 256, 128, QuantType.QUInt4, QuantizationStrategy.GROUP, 64)

    def path(shape):
        return select_path(shape, qt, backend="gpu", impl="auto")

    assert path((32,)) == "w4"
    assert path((32, 16)) == "jnp"
    assert path((256, 1)) == "w4"
    assert path((4096,)) == "jnp"


def _w8(rng):
    return _qt(rng, 64, 128, QuantType.QInt8, QuantizationStrategy.CHANNEL, -1,
               sym=True)


def _qlinear(rng):
    return _qt(
        rng, 64, 128, QuantType.QUInt8, QuantizationStrategy.CHANNEL, -1,
        sym=True, fmt=QFormat.QLINEAR,
        input_quant=ActQuantSpec(mode="static", dtype="uint8"),
        output_quant=ActQuantSpec(mode="static", dtype="uint8"),
        input_scale=np.float32(0.1), input_zero_point=np.float32(128),
        output_scale=np.float32(0.1), output_zero_point=np.float32(128),
    )


@pytest.mark.parametrize("make, shape, backend, impl, want", [
    # W4 on the GPU under auto: decode steps and small M on the kernel.
    ("w4", (1, 1), "gpu", "auto", "w4"),
    ("w4", (32, 1), "gpu", "auto", "w4"),
    ("w4", (512, 1), "gpu", "auto", "w4"),
    ("w4", (1,), "gpu", "auto", "w4"),
    ("w4", (W4_MAX_M,), "gpu", "auto", "w4"),
    ("w4", (W4_MAX_M + 1,), "gpu", "auto", "jnp"),
    ("w4", (32, 512), "gpu", "auto", "jnp"),
    # Off the GPU, auto is always the oracle.
    ("w4", (32, 1), "cpu", "auto", "jnp"),
    # Weight-only 8-bit channel sites: the folded plain-XLA path on the GPU,
    # the oracle elsewhere; QLinear keeps the oracle.
    ("w8", (32, 1), "gpu", "auto", "w8_fold"),
    ("w8", (4096,), "gpu", "pallas", "w8_fold"),
    ("w8", (32, 1), "cpu", "auto", "jnp"),
    ("qlinear", (32, 1), "gpu", "auto", "jnp"),
    # impl="jnp" forces the oracle; impl="pallas" takes the kernel on the GPU.
    ("w4", (32, 1), "gpu", "jnp", "jnp"),
    ("w4", (4096,), "gpu", "pallas", "w4"),
])
def test_select_path(rng, make, shape, backend, impl, want):
    qt = {
        "w4": lambda: _qt(rng, 256, 128, QuantType.QUInt4,
                          QuantizationStrategy.GROUP, 64),
        "w8": lambda: _w8(rng),
        "qlinear": lambda: _qlinear(rng),
    }[make]()
    assert select_path(shape, qt, backend=backend, impl=impl) == want


@pytest.mark.parametrize("gs, N, covered", [
    (16, 32, True), (128, 13824, True), (8, 128, False), (24, 128, False),
    (64, 48, False),
])
def test_w4_coverage(rng, gs, N, covered):
    qt = _qt(rng, 4 * gs, N, QuantType.QUInt4, QuantizationStrategy.GROUP, gs)
    want = "w4" if covered else "jnp"
    assert select_path((1, 1), qt, backend="gpu", impl="auto") == want


def test_pallas_off_gpu_needs_explicit_interpret(rng):
    qt = _qt(rng, 64, 128, QuantType.QUInt4, QuantizationStrategy.GROUP, 16)
    with pytest.raises(ValueError, match="interpret=True"):
        select_path((4,), qt, backend="cpu", impl="pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        select_path((4,), qt, backend="gpu", impl="mosaic")


@pytest.mark.parametrize("K, N, gs, M, dtype", [
    (1152, 1536, 128, 32, "bfloat16"),   # 1B fused qkv, decode, split-K
    (1152, 13824, 128, 1, "bfloat16"),   # 1B gate_up
    (6912, 1152, 128, 64, "float32"),    # 1B down
    (640, 128, -1, 8, "float32"),        # channel: 64-row tiles of a 320-row group
])
def test_w4_kernel_lowers_to_triton(rng, K, N, gs, M, dtype):
    """The kernel lowers to Triton IR for CUDA on a machine without a GPU
    (cross-platform lowering): a primitive the Triton route cannot lower fails
    here, before the card. Compiling the IR to PTX happens on the card."""
    import jax

    from onnx_quantize_tpu.engine import prepare_kernel_scales
    from onnx_quantize_tpu.ops.kernels.matmul_w4 import (
        _expand_scales,
        _w4_call,
        pick_blocks,
    )

    strategy = QuantizationStrategy.GROUP if gs > 0 else QuantizationStrategy.CHANNEL
    qt = prepare_kernel_scales(_qt(rng, K, N, QuantType.QInt4, strategy, gs))
    half = qt.data.shape[0]
    pg = qt.meta.pack_group
    b = pick_blocks(M, N, pg, half // pg, jnp.dtype(dtype).itemsize)
    x2d = jnp.zeros((-(-M // b.bm) * b.bm, 2 * half), dtype)
    s, z = _expand_scales(qt, 2 * half // pg, N)
    s, z = s.reshape(-1, 2, N), z.reshape(-1, 2, N)

    def call(x2d, data, s, z):
        return _w4_call(x2d, data, s, z, gs=pg, signed=True, blocks=b,
                        interpret=False)

    lowered = jax.jit(call).trace(x2d, qt.data, s, z).lower(
        lowering_platforms=("cuda",)
    )
    assert "__gpu$xla.gpu.triton" in lowered.as_text()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy, sym, qt_type", [
    (QuantizationStrategy.CHANNEL, True, QuantType.QInt8),
    (QuantizationStrategy.CHANNEL, False, QuantType.QUInt8),
    (QuantizationStrategy.TENSOR, False, QuantType.QInt8),
])
def test_w8_folded_matches_reference(rng, strategy, sym, qt_type, dtype):
    """The folded 8-bit path equals the oracle: raw codes are exact in bf16,
    so only the rounding of the dequantized weight (oracle, bf16) and the
    summation order differ."""
    from onnx_quantize_tpu.ops.folded import w8_folded_matmul

    qt = _qt(rng, 100, 128, qt_type, strategy, -1, sym=sym)
    x = jnp.asarray(rng.standard_normal((5, 100)), dtype)
    _check(w8_folded_matmul(x, qt), quantized_matmul_jnp(x, qt),
           F32_TOL if dtype == "float32" else BF16_TOL)

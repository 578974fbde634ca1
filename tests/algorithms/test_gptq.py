import numpy as np
import pytest

from onnx_quantize_tpu.algorithms.gptq import accumulate_hessian, gptq_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy


def _weights_and_inputs(rng, K=32, N=8, S=64):
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    x = rng.standard_normal((S, K)).astype(np.float32)
    return w, x


def test_accumulate_hessian_formula(rng):
    x = rng.standard_normal((16, 8)).astype(np.float32)
    H = np.zeros((8, 8), dtype=np.float32)
    H, n = accumulate_hessian(x, H, 0)
    assert n == 16
    np.testing.assert_allclose(H, (2.0 / 16) * x.T @ x, rtol=1e-5)


def test_accumulate_hessian_running_renormalization(rng):
    x = rng.standard_normal((16, 8)).astype(np.float32)
    H_once, _ = accumulate_hessian(x, np.zeros((8, 8), np.float32), 0)
    H_a, n = accumulate_hessian(x[:8], np.zeros((8, 8), np.float32), 0)
    H_ab, n = accumulate_hessian(x[8:], H_a, n)
    np.testing.assert_allclose(H_ab, H_once, rtol=1e-4)


@pytest.mark.parametrize("block_size", [8, 16, 128])
@pytest.mark.parametrize("strategy, gs", [
    (QuantizationStrategy.TENSOR, -1),
    (QuantizationStrategy.CHANNEL, -1),
    (QuantizationStrategy.GROUP, 16),
])
@pytest.mark.parametrize("actorder", [False, True])
def test_gptq_shapes_dtypes_ranges(rng, block_size, strategy, gs, actorder):
    w, x = _weights_and_inputs(rng)
    q, scale, zp = gptq_quantize(
        w, x, quant_type=QuantType.QInt8, strategy=strategy, group_size=gs,
        block_size=block_size, actorder=actorder,
    )
    assert q.shape == w.shape
    assert q.dtype == np.int8
    qmin, qmax = QuantType.QInt8.qrange(False)
    assert q.min() >= qmin and q.max() <= qmax
    if strategy == QuantizationStrategy.CHANNEL:
        assert scale.shape == (w.shape[1],)
    elif strategy == QuantizationStrategy.GROUP:
        assert scale.shape == (w.shape[1] * (w.shape[0] // gs), 1)
    assert zp.dtype == np.int8


@pytest.mark.parametrize("mse", [False, True])
@pytest.mark.parametrize("actorder", [False, True])
@pytest.mark.parametrize("K, gs", [(24, 8), (20, 8)])  # aligned and ragged tail
def test_gptq_jit_matches_host_sweep(rng, mse, actorder, K, gs):
    """The single-program lax sweep (incl. in-jit mse search, ragged-group
    zero padding, group-aligned actorder) must agree with the numpy oracle:
    no silent host fallback remains."""
    w, x = _weights_and_inputs(rng, K=K, N=8)
    q_jit, s_jit, z_jit = gptq_quantize(
        w, x, quant_type=QuantType.QInt8, strategy=QuantizationStrategy.GROUP,
        group_size=gs, block_size=16, mse=mse, actorder=actorder,
    )
    q_host, s_host, z_host = gptq_quantize(
        w, x, quant_type=QuantType.QInt8, strategy=QuantizationStrategy.GROUP,
        group_size=gs, block_size=16, mse=mse, actorder=actorder,
        _force_host=True,
    )
    np.testing.assert_array_equal(q_jit, q_host)
    np.testing.assert_allclose(s_jit, s_host, rtol=1e-6)
    np.testing.assert_array_equal(z_jit, z_host)


def test_gptq_group_actorder_exact_artifact(rng):
    """GROUP+actorder must emit scales that dequantize the error-corrected
    result exactly (the reference requantizes from the dequantized weight,
    gptq.py:218-231, which is lossy). Exactness shows as idempotence under the
    emitted qparams AND as not degrading the matmul error vs no-actorder.

    Semantics note (reference vs repo, documented in PARITY.md row 8): the
    reference permutes individual rows by diag(H) so its loop groups straddle
    original group boundaries, forcing the lossy post-hoc requantization this
    test rejects. The repo instead uses a *group-aligned* permutation (whole
    groups ordered by max diag(H), rows ordered within groups) — loop groups
    equal original groups, loop-time scales are the artifact. Consequence:
    actorder+GROUP artifacts are deliberately NOT bit-comparable with the
    reference's; this test pins the repo's (strictly tighter) contract."""
    from onnx_quantize_tpu.core.numerics import dequantize

    K, N, S, gs = 64, 16, 256, 16
    base = rng.standard_normal((S, 8)).astype(np.float32)
    mix = rng.standard_normal((8, K)).astype(np.float32)
    x = base @ mix + 0.1 * rng.standard_normal((S, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)

    q_ao, s_ao, z_ao = gptq_quantize(
        w, x, quant_type=QuantType.QInt4, strategy=QuantizationStrategy.GROUP,
        group_size=gs, actorder=True,
    )
    q_no, s_no, z_no = gptq_quantize(
        w, x, quant_type=QuantType.QInt4, strategy=QuantizationStrategy.GROUP,
        group_size=gs, actorder=False,
    )
    dq_ao = np.asarray(dequantize(q_ao, s_ao, z_ao, preprocess=True,
                                  strategy=QuantizationStrategy.GROUP, group_size=gs))
    dq_no = np.asarray(dequantize(q_no, s_no, z_no, preprocess=True,
                                  strategy=QuantizationStrategy.GROUP, group_size=gs))
    err_ao = np.linalg.norm(x @ w - x @ dq_ao)
    err_no = np.linalg.norm(x @ w - x @ dq_no)
    assert err_ao <= err_no * 1.05  # exact artifact: no lossy requantization tax


def test_gptq_degenerate_hessian_falls_back_to_rtn(rng):
    """A rank-deficient Hessian triggers the identity-Hinv (RTN) fallback."""
    w = (0.1 * rng.standard_normal((16, 4))).astype(np.float32)
    x = np.zeros((8, 16), dtype=np.float32)
    x[:, 0] = 1.0  # rank-1 Hessian with many dead channels
    q, scale, zp = gptq_quantize(
        w, x, quant_type=QuantType.QInt8, strategy=QuantizationStrategy.CHANNEL,
        group_size=-1,
    )
    assert q.shape == w.shape


def test_gptq_reduces_output_error_vs_rtn(rng):
    """GPTQ should beat RTN on ||XW - X dq(W)|| for a correlated-input matmul."""
    from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
    from onnx_quantize_tpu.core.numerics import dequantize

    K, N, S = 64, 16, 256
    base = rng.standard_normal((S, 8)).astype(np.float32)
    mix = rng.standard_normal((8, K)).astype(np.float32)
    x = base @ mix + 0.1 * rng.standard_normal((S, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)

    q_g, s_g, z_g = gptq_quantize(
        w, x, quant_type=QuantType.QInt4, strategy=QuantizationStrategy.CHANNEL,
        group_size=-1,
    )
    q_r, s_r, z_r = rtn_quantize(
        w, QuantType.QInt4, QuantizationStrategy.CHANNEL, -1, False, False
    )
    dq_g = np.asarray(dequantize(q_g, s_g, z_g, preprocess=True,
                                 strategy=QuantizationStrategy.CHANNEL, group_size=-1))
    dq_r = np.asarray(dequantize(q_r, s_r, z_r, preprocess=True,
                                 strategy=QuantizationStrategy.CHANNEL, group_size=-1))
    err_g = np.linalg.norm(x @ w - x @ dq_g)
    err_r = np.linalg.norm(x @ w - x @ dq_r)
    assert err_g < err_r


def test_gptq_actorder_roundtrip(rng):
    w, x = _weights_and_inputs(rng, K=32, N=8)
    q_no, _, _ = gptq_quantize(w, x, strategy=QuantizationStrategy.CHANNEL, group_size=-1)
    q_ao, _, _ = gptq_quantize(
        w, x, strategy=QuantizationStrategy.CHANNEL, group_size=-1, actorder=True
    )
    # Same shape and a mostly-similar result (the permutation is undone).
    assert q_ao.shape == q_no.shape
    assert np.mean(q_ao == q_no) > 0.5

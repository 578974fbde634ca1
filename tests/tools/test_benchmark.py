"""Benchmark harness: structure + roofline accounting (CPU, tiny shapes).

Timing on CPU is meaningless as a perf number; these tests pin the harness's
CONTRACT — the in-jit chained loop runs the measured function, the report
carries the roofline fields, the ceiling math is consistent, and a device
without published peaks is an error.
"""

import numpy as np

import jax.numpy as jnp

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy
from onnx_quantize_tpu.nn.qtensor import make_qtensor
import pytest

from onnx_quantize_tpu.tools.benchmark import (
    H100_SXM,
    bench_fn,
    bench_quantized_matmul,
    chip_spec,
)


def _qt(rng, K=64, N=128, gs=16):
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    q, s, zp = rtn_quantize(w, QuantType.QUInt4, QuantizationStrategy.GROUP,
                            gs, False, False)
    return make_qtensor(q, s, zp, quant_type=QuantType.QUInt4,
                        strategy=QuantizationStrategy.GROUP, group_size=gs,
                        symmetric=False, reduce_range=False)


def test_bench_fn_measures_positive_slope(rng):
    x = jnp.asarray(rng.standard_normal((8, 16)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((16, 16)), jnp.float32)
    sec = bench_fn(lambda a, wt: a @ wt, x, w, iters=12)
    assert sec > 0


def test_bench_quantized_matmul_report(rng):
    qt = _qt(rng)
    report = bench_quantized_matmul(qt, M=8, iters=8, impl="jnp", chip=H100_SXM)
    assert report["shape"] == "8x64x128"
    assert report["chip"] == "H100 SXM"
    assert report["bound"] in ("compute", "memory")
    assert report["time_us"] > 0 and report["tflops"] > 0 and report["hbm_gbps"] > 0
    # Roofline consistency: pct = ceiling/sec, ceiling from the SLOWER of the
    # two limits at the configured peaks.
    flops = 2 * 8 * 64 * 128
    weight_bytes = np.asarray(qt.data).nbytes + np.asarray(qt.scale).nbytes
    bytes_accessed = weight_bytes + 8 * 64 * 2 + 8 * 128 * 4
    ceiling = max(flops / (H100_SXM.peak_bf16_tflops * 1e12),
                  bytes_accessed / (H100_SXM.hbm_gbps * 1e9))
    sec = report["time_us"] / 1e6
    assert abs(report["pct_roofline"] - 100 * ceiling / sec) < 0.5
    assert 0 < report["pct_roofline"] <= 100


def test_chip_spec_known_and_unknown():
    assert chip_spec("NVIDIA H100 80GB HBM3") is H100_SXM
    with pytest.raises(ValueError, match="no published peaks"):
        chip_spec("cpu")


def test_bench_defaults_to_device_peaks(rng):
    """Without ``chip`` the peaks come from the device that runs the bench —
    here the CPU, which has none: an error, not a default."""
    with pytest.raises(ValueError, match="no published peaks"):
        bench_quantized_matmul(_qt(rng), M=8, iters=8, impl="jnp")

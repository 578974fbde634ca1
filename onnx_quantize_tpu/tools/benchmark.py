"""Kernel benchmark + roofline accounting harness.

The profiling deliverable from SURVEY.md §5 ("tracing/profiling"): measures a
quantized matmul config with in-jit repetition (sequential data dependency so
XLA cannot hoist the work), and reports achieved TFLOP/s, HBM GB/s, and the
percent-of-roofline implied by the device's published peaks (``PEAKS``, keyed
by ``device_kind``; a device missing from the table is an error). Usage:

    python -m onnx_quantize_tpu.tools.benchmark --kernel w4 --m 32 --k 1152 --n 13824
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["ChipSpec", "PEAKS", "H100_SXM", "chip_spec", "bench_fn",
           "bench_quantized_matmul"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_tflops: float
    peak_int8_tops: float
    hbm_gbps: float


# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit.
H100_SXM = ChipSpec(
    name="H100 SXM", peak_bf16_tflops=989.0, peak_int8_tops=1979.0,
    hbm_gbps=3350.0,
)

# Published peaks by ``jax.Device.device_kind``.
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def chip_spec(device_kind: str) -> ChipSpec:
    """Published peaks of ``device_kind``; unknown devices are an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r} "
            f"(known: {sorted(PEAKS)}); add them to tools.benchmark.PEAKS"
        ) from None


def bench_fn(fn, x, *operands, iters: int = 200) -> float:
    """Seconds per call: slope between two in-jit chained trip counts.

    ``operands`` (weights, QTensors — any pytree) are passed as jit
    ARGUMENTS; closure-captured arrays would become HLO constants baked into
    the program.

    Two XLA rewrites shape the loop body: (1) XLA distributes dot(x0+s, W)
    and hoists the loop-invariant dots, so the carry is mixed in through
    tanh; (2) sum(dot(x, W)) is rewritten to (colsum x)@(rowsum W), so abs()
    sits between dot and reduce. The estimate is the SLOPE between two trip
    counts, so the fixed cost of a call (dispatch and the host sync) cancels.
    """

    def timed(n):
        @jax.jit
        def loop(x0, seed, *ops):
            def body(i, carry):
                xi = jnp.tanh(x0 + carry).astype(x0.dtype)
                y = fn(xi, *ops)
                return jnp.sum(jnp.abs(y)).astype(jnp.float32) * 1e-30 + carry

            return jax.lax.fori_loop(0, n, body, seed)

        float(loop(x, jnp.float32(0.0), *operands))  # true sync: compile + warm
        times = []
        for rep in range(3):
            seed = jnp.float32((rep + 1) * 1e-6)
            t = time.time()
            loop(x, seed, *operands).block_until_ready()
            times.append(time.time() - t)
        return float(np.median(times))

    # lo must stay strictly below hi even for tiny iters (iters < 40 used to
    # produce lo=10 > hi and a NEGATIVE slope divisor).
    lo = max(iters // 4, 10)
    hi = max(iters, 2 * lo)
    est = max(timed(hi) - timed(lo), 1e-9) / (hi - lo)
    # The fixed per-call cost jitters run to run, so the slope delta must
    # dwarf it: rescale the trip counts so (t_hi - t_lo) targets ~300 ms when
    # the pilot estimate is too small (sub-10-us arms otherwise read noise).
    want_hi = int(0.3 / est)
    if want_hi > 2 * hi:
        hi = min(want_hi, 200_000)
        lo = hi // 4
        est = max(timed(hi) - timed(lo), 1e-9) / (hi - lo)
    return est


def bench_quantized_matmul(qt, M: int, *, chip: ChipSpec | None = None,
                           iters: int = 50, dtype=jnp.bfloat16,
                           impl: str = "pallas",
                           with_control: bool = False) -> dict:
    """Benchmark one QTensor matmul; returns the measurement + roofline %.

    ``chip`` defaults to the peaks of the device the benchmark runs on.
    ``impl="pallas"`` runs the path ``ops.quantized_matmul`` takes when
    kernels are asked for (the W4 kernel or the folded 8-bit path where they
    cover the config, else the oracle), ``"jnp"`` the reference semantics as
    XLA compiles them, and ``"dense"`` the platform-ceiling
    control: a plain XLA dot against the pre-dequantized bf16 weight at the
    SAME shape. Its achieved GB/s is the device's own demonstrated
    dense-stream rate, a fairer ceiling than the data sheet's.

    ``with_control=True`` measures the dense control IN THE SAME SESSION and
    adds the gate metric a roofline claim closes on:
    ``pct_of_dense_control`` — the kernel's achieved byte rate as a percent
    of the same-shape dense-bf16 control's — plus ``speedup_vs_dense``
    (time ratio; > 1 means the quantized kernel is faster outright).
    """
    from onnx_quantize_tpu.ops import quantized_matmul
    from onnx_quantize_tpu.ops.reference import dequantize_weight, quantized_matmul_jnp

    if chip is None:
        chip = chip_spec(jax.devices()[0].device_kind)
    K, N = qt.meta.shape
    x = jnp.asarray(np.random.default_rng(0).standard_normal((M, K)), dtype=dtype)

    if impl == "dense":
        w_dense = dequantize_weight(qt).astype(dtype)
        sec = bench_fn(lambda a, w: a @ w, x, w_dense, iters=iters)
        weight_bytes = int(np.asarray(w_dense).nbytes)
    else:
        if impl == "pallas":
            def call(a, w, b):
                return quantized_matmul(a, w, b, impl="pallas")
        else:
            call = quantized_matmul_jnp
        sec = bench_fn(lambda a, w: call(a, w, None), x, qt, iters=iters)
        weight_bytes = int(np.asarray(qt.data).nbytes + np.asarray(qt.scale).nbytes)

    flops = 2 * M * K * N
    bytes_accessed = weight_bytes + x.nbytes + M * N * 4
    tflops = flops / sec / 1e12
    gbps = bytes_accessed / sec / 1e9

    # Roofline: compute-bound ceiling vs bandwidth-bound ceiling.
    compute_ceiling = flops / (chip.peak_bf16_tflops * 1e12)
    memory_ceiling = bytes_accessed / (chip.hbm_gbps * 1e9)
    ceiling_sec = max(compute_ceiling, memory_ceiling)
    out = {
        "shape": f"{M}x{K}x{N}",
        "quant": f"{qt.meta.quant_type}/{qt.meta.strategy}/g{qt.meta.group_size}",
        "time_us": round(sec * 1e6, 1),
        "tflops": round(tflops, 2),
        "hbm_gbps": round(gbps, 1),
        "bound": "compute" if compute_ceiling >= memory_ceiling else "memory",
        "pct_roofline": round(100 * ceiling_sec / sec, 1),
        "chip": chip.name,
    }
    if with_control and impl != "dense":
        ctrl = bench_quantized_matmul(
            qt, M, chip=chip, iters=iters, dtype=dtype, impl="dense"
        )
        out["dense_time_us"] = ctrl["time_us"]
        out["dense_hbm_gbps"] = ctrl["hbm_gbps"]
        out["pct_of_dense_control"] = round(100 * gbps / ctrl["hbm_gbps"], 1)
        out["speedup_vs_dense"] = round(ctrl["time_us"] / out["time_us"], 2)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernel", choices=["w4", "w8", "w4a8"], default="w4",
                        help="weight format: w4, w8, or w4 with dynamic int8 "
                             "activations (w4a8)")
    parser.add_argument("--m", type=int, default=1024)
    parser.add_argument("--k", type=int, default=2048)
    parser.add_argument("--n", type=int, default=2048)
    parser.add_argument("--group-size", type=int, default=128)
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--impl", choices=["pallas", "jnp", "dense"], default="pallas")
    parser.add_argument("--control", action="store_true",
                        help="also measure the same-shape dense-bf16 control "
                             "and report pct_of_dense_control (the gate metric)")
    args = parser.parse_args()

    from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
    from onnx_quantize_tpu.core.dtypes import QuantType
    from onnx_quantize_tpu.core.enums import QuantizationStrategy
    from onnx_quantize_tpu.nn.qtensor import ActQuantSpec, make_qtensor

    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = jax.devices()[0]
    with jax.default_device(cpu):
        rng = np.random.default_rng(0)
        w = (0.1 * rng.standard_normal((args.k, args.n))).astype(np.float32)
        qt_type = QuantType.QUInt4 if args.kernel in ("w4", "w4a8") else QuantType.QInt8
        q, s, zp = rtn_quantize(
            w, qt_type, QuantizationStrategy.GROUP, args.group_size, False, False
        )
        extra = {}
        if args.kernel == "w4a8":
            extra["input_quant"] = ActQuantSpec(mode="dynamic", dtype="int8", symmetric=True)
        qt = make_qtensor(
            q, s, zp, quant_type=qt_type, strategy=QuantizationStrategy.GROUP,
            group_size=args.group_size, symmetric=False, reduce_range=False, **extra,
        )
    import jax.tree_util as jtu

    qt = jtu.tree_map(lambda a: jax.device_put(a, jax.devices()[0]), qt)
    result = bench_quantized_matmul(qt, args.m, iters=args.iters, impl=args.impl,
                                    with_control=args.control)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

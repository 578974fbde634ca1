"""Which path each quantized matmul takes, per backend and per shape.

One decision, made by :func:`select_path` from explicit arguments so it can be
tested anywhere:

  * ``"w4"``: the fused W4 dequant-matmul kernel (``kernels/matmul_w4.py``,
    Pallas on the Triton route).
  * ``"w8_fold"``: weight-only 8-bit channel/tensor sites with the dequant
    affine folded onto the product (``ops/folded.py``) — plain XLA, which
    fuses the int8 convert into the GEMM instead of materializing a
    dequantized weight the way the oracle's formulation does.
  * ``"jnp"``: the pure-jnp reference semantics (``ops/reference.py``), which
    XLA compiles for whatever backend runs it.

Under ``impl="auto"`` the kernel serves packed-W4 sites on the GPU at decode:
every ``(B, 1, K)`` decode step, and any other call of at most
``W4_MAX_M`` rows. Above that the dequantize-then-dense path (cuBLAS) wins,
because the dot is compute-bound and the transient dequant traffic is
amortized over the rows. Inside a decode scan the dense path would
re-materialize the dequantized weight every step, so decode steps stay on the
kernel at any batch. ``impl="pallas"`` asks for the kernel wherever it covers
the config; off the GPU that is only allowed in interpret mode. The
``w8_fold`` path serves its sites on the GPU under both.
"""

from __future__ import annotations

import numpy as np

from onnx_quantize_tpu.nn.qtensor import QTensor
from onnx_quantize_tpu.ops.folded import w8_fold_supported
from onnx_quantize_tpu.ops.kernels.matmul_w4 import w4_supported

__all__ = ["select_path", "W4_MAX_M"]

# Largest row count (outside decode steps) at which the W4 kernel beats
# dequantize-then-dense on the H100. Per one-shot call at the Gemma-3 1B and
# 4B body sites it won at M = 64 at every site, split the sites at M = 128,
# and lost at M = 256 and above at nearly all (2-5x at M = 16384); the
# kernel re-reads the packed weights for every 64-row block. chip_smoke.py's
# kernel phase prints both times at these M; PERF.md has the readings.
W4_MAX_M = 64


def select_path(batch_shape: tuple, qt: QTensor, *, backend: str, impl: str,
                interpret: bool = False) -> str:
    """``"w4"``, ``"w8_fold"`` or ``"jnp"`` for ``x[batch_shape + (K,)] @ qt``."""
    if impl == "jnp":
        return "jnp"
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    if backend == "gpu" and w8_fold_supported(qt):
        return "w8_fold"
    covered = w4_supported(qt)
    if impl == "pallas":
        if backend != "gpu" and not interpret:
            raise ValueError(
                f"impl='pallas' compiles its kernels for the GPU; on {backend!r}"
                " ask for the interpreter explicitly (set_impl('pallas', "
                "interpret=True))"
            )
        return "w4" if covered else "jnp"
    if backend != "gpu" or not covered:
        return "jnp"
    is_decode_step = len(batch_shape) >= 2 and batch_shape[-1] == 1
    M = int(np.prod(batch_shape)) if batch_shape else 1
    return "w4" if is_decode_step or M <= W4_MAX_M else "jnp"

"""Quantized op dispatch.

``quantized_matmul`` is the single execution chokepoint for quantized linear
sites (the analogue of the reference's qfunction factory,
``qfunctions/factory.py:22``). The implementation is selected globally:

  * ``"jnp"``: the pure-jnp reference semantics (oracle).
  * ``"pallas"``: the fused GPU kernel wherever it covers the config; off the
    GPU only with ``interpret=True`` (Pallas interpreter, for tests).
  * ``"auto"``: per backend and shape, see :func:`ops.dispatch.select_path`.
"""

from __future__ import annotations

import jax

from onnx_quantize_tpu.nn.qtensor import QTensor
from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp

__all__ = ["quantized_matmul", "set_impl", "get_impl", "convert_to_w4a8"]


def convert_to_w4a8(params):
    """Switch weights-only QTensors to the dynamic-int8-activation (A8) mode.

    Sets ``input_quant`` to dynamic symmetric int8 on packed 4-bit weights
    and symmetric 8-bit weights; the jnp semantics then fake-quantize each
    activation per tensor before the dot. A capability extension beyond the
    reference (whose config layer restricts 4-bit to weights-only,
    ``_qconfig.py:482-485``): the artifact is unchanged, only the execution
    spec differs. Skips HQQ weights (float zero points cannot center in int8).
    """
    import dataclasses

    import jax.numpy as jnp

    from onnx_quantize_tpu.nn.qtensor import ActQuantSpec

    def eligible(qt: QTensor) -> bool:
        if qt.meta.input_quant.mode != "none":
            return False
        if jnp.issubdtype(qt.zero_point.dtype, jnp.floating) and qt.meta.packed:
            return False
        if qt.meta.packed:
            return True
        return qt.meta.qt.bitwidth == 8 and qt.meta.symmetric

    def visit(tree):
        if isinstance(tree, dict):
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, QTensor) and eligible(tree):
            meta = dataclasses.replace(
                tree.meta,
                input_quant=ActQuantSpec(mode="dynamic", dtype="int8", symmetric=True),
            )
            return QTensor(
                tree.data, tree.scale, tree.zero_point, meta,
                tree.input_scale, tree.input_zero_point,
                tree.output_scale, tree.output_zero_point,
            )
        return tree

    return visit(params)

_IMPL = "auto"
_INTERPRET = False


def set_impl(impl: str, *, interpret: bool = False) -> None:
    """Select the quantized-matmul implementation for every later trace.

    ``interpret=True`` runs Pallas kernels in the interpreter: the only way
    ``impl="pallas"`` is allowed off the GPU."""
    global _IMPL, _INTERPRET
    assert impl in {"auto", "jnp", "pallas"}, impl
    _IMPL = impl
    _INTERPRET = interpret


def get_impl() -> str:
    return _IMPL


def quantized_matmul(x, qt: QTensor, bias=None, *, impl: str | None = None):
    """``x @ dequant(qt) + bias`` on the path :func:`ops.dispatch.select_path`
    picks; ``impl`` overrides the global selection for this call."""
    from onnx_quantize_tpu.ops.dispatch import select_path

    path = select_path(
        x.shape[:-1], qt, backend=jax.default_backend(),
        impl=_IMPL if impl is None else impl, interpret=_INTERPRET,
    )
    if path == "w4":
        from onnx_quantize_tpu.ops.kernels.matmul_w4 import w4_entry

        return w4_entry(x, qt, bias, interpret=_INTERPRET)
    if path == "w8_fold":
        from onnx_quantize_tpu.ops.folded import w8_folded_matmul

        return w8_folded_matmul(x, qt, bias)
    return quantized_matmul_jnp(x, qt, bias)

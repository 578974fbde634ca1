"""Horizontal fusion of same-input linear sites (q/k/v, gate/up).

Decode at small batch pays a fixed cost per kernel launch; fusing sites that share an input into one wider matmul cuts the
launch count without changing numerics: packed data, scales, and zero points
concatenate along N (same K, same group geometry), so the fused kernel
computes exactly the concatenation of the per-site outputs.

Fusion is an engine-load transform applied *after* quantization — sites with
per-site input prescales (AWQ/SmoothQuant) or mismatched quantization specs
are left unfused.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.nn.qtensor import QTensor

logger = get_logger(__name__)

__all__ = ["fuse_sites", "can_fuse"]


def _compatible_meta(a: QTensor, b: QTensor) -> bool:
    ma, mb = a.meta, b.meta
    return (
        ma.quant_type == mb.quant_type
        and ma.strategy == mb.strategy
        and ma.group_size == mb.group_size
        and ma.symmetric == mb.symmetric
        and ma.reduce_range == mb.reduce_range
        and ma.format == mb.format
        and ma.packed == mb.packed
        and ma.pack_group == mb.pack_group
        and ma.shape[0] == mb.shape[0]
        and ma.input_quant == mb.input_quant
        and ma.output_quant == mb.output_quant
    )


def _act_equal(a, b) -> bool:
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    return bool(np.allclose(np.asarray(a), np.asarray(b)))


def can_fuse(site_params: list[dict]) -> bool:
    """All sites quantized alike, no bias, no per-site prescale."""
    leaves = [p.get("w") for p in site_params]
    if any(p.get("b") is not None or p.get("prescale") is not None for p in site_params):
        return False
    if all(isinstance(w, QTensor) for w in leaves):
        first = leaves[0]
        if first.meta.output_quant.mode == "static":
            return False  # per-site output scales cannot concatenate per-tensor
        if first.meta.strategy == "tensor":
            return False  # per-tensor weight scales differ between sites
        return all(
            _compatible_meta(first, w)
            and _act_equal(first.input_scale, w.input_scale)
            and _act_equal(first.input_zero_point, w.input_zero_point)
            for w in leaves[1:]
        )
    if all(not isinstance(w, QTensor) and w is not None for w in leaves):
        return all(w.ndim == 2 and w.shape[0] == leaves[0].shape[0] for w in leaves)
    return False


def fuse_sites(site_params: list[dict]):
    """Fuse the weights of compatible sites; returns (fused_w, split_sizes)."""
    leaves = [p["w"] for p in site_params]
    sizes = [
        (w.meta.shape[1] if isinstance(w, QTensor) else w.shape[1]) for w in leaves
    ]

    if not isinstance(leaves[0], QTensor):
        return jnp.concatenate(leaves, axis=1), sizes

    first = leaves[0]
    K = first.meta.shape[0]
    N_total = sum(sizes)

    def cat(attr):
        vals = [getattr(w, attr) for w in leaves]
        if vals[0] is None:
            return None
        arrs = [jnp.asarray(v) for v in vals]
        if arrs[0].ndim == 0:
            # per-tensor qparams: identical across sites (checked by can_fuse
            # for act params; weight per-tensor scales generally differ, so
            # tensor-strategy weights are rejected below).
            return arrs[0]
        return jnp.concatenate(arrs, axis=-1)

    if first.meta.strat.value == "tensor":
        raise ValueError("Cannot fuse per-tensor-quantized weights (scales differ).")

    meta = dataclasses.replace(first.meta, shape=(K, N_total))
    fused = QTensor(
        data=jnp.concatenate([jnp.asarray(w.data) for w in leaves], axis=1),
        scale=cat("scale"),
        zero_point=cat("zero_point"),
        meta=meta,
        input_scale=first.input_scale,
        input_zero_point=first.input_zero_point,
        output_scale=None,
        output_zero_point=None,
    )
    return fused, sizes

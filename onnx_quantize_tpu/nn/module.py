"""Minimal functional module system.

The JAX stand-in for the reference's ONNX graph: a model is a tree of
:class:`Module` objects (static structure) plus a separate params pytree
(dicts mirroring the tree). Quantizable matmuls are :class:`Linear` sites — a
Linear with bias is a "Gemm" site, without bias a "MatMul" site, matching the
reference's ``target_op_types`` vocabulary (``_qconfig.py:28``).

Activation taps replace the reference's output-augmentation trick
(``calibrate.py:108-124``): running ``apply`` with a :class:`Context` whose
``taps`` dict is set records each target site's input (post-prescale, i.e.
immediately before the matmul) and output (post-bias) into the trace, which a
jitted wrapper returns alongside the model output.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from onnx_quantize_tpu.nn.qtensor import QTensor
from onnx_quantize_tpu.plan import LinearSite

__all__ = ["Context", "Module", "Linear", "Sequential", "InputSpec"]


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Declared model input: used by the random-calibration-data fallback.

    ``shape`` excludes the batch dimension; integer dtypes are sampled in
    ``[0, 100)`` (valid token ids / mask values), floats from a standard normal
    — mirroring ``calibrate.py:127-147``.
    """

    name: str
    shape: tuple[int, ...]
    dtype: Any = jnp.float32


@dataclasses.dataclass
class Context:
    """Per-call execution context: activation tap collection."""

    taps: dict[str, dict[str, Any]] | None = None
    tap_inputs: bool = False
    tap_outputs: bool = False
    tap_names: set[str] | None = None  # None = all target sites

    def collect(self, name: str, kind: str, value) -> None:
        if self.taps is None:
            return
        if kind == "input" and not self.tap_inputs:
            return
        if kind == "output" and not self.tap_outputs:
            return
        if self.tap_names is not None and name not in self.tap_names:
            return
        self.taps.setdefault(name, {})[kind] = value


class Module:
    """Base module: children are attributes that are themselves Modules.

    Params are plain nested dicts shaped like the child tree. Site names are
    dotted attribute paths assigned by :meth:`finalize` (idempotent; called
    lazily by :meth:`linear_sites`).
    """

    # Declared inputs (used for random calibration data); models override.
    input_specs: list[InputSpec] | None = None

    def __init__(self):
        object.__setattr__(self, "_children", {})
        object.__setattr__(self, "_name", None)

    def __setattr__(self, key: str, value) -> None:
        if isinstance(value, Module):
            self._children[key] = value
        object.__setattr__(self, key, value)

    @property
    def name(self) -> str | None:
        return self._name

    def finalize(self, prefix: str = "") -> "Module":
        """Assign dotted path names to every module in the tree."""
        object.__setattr__(self, "_name", prefix.rstrip("."))
        for key, child in self._children.items():
            child.finalize(f"{prefix}{key}." if prefix else f"{key}.")
        return self

    def init(self, rng: jax.Array) -> dict:
        """Default init: split the rng over children."""
        params: dict[str, Any] = {}
        keys = jax.random.split(rng, max(len(self._children), 1))
        for key, (name, child) in zip(keys, self._children.items()):
            params[name] = child.init(key)
        return params

    def __call__(self, params, *args, ctx: Context | None = None):
        raise NotImplementedError

    def linear_sites(self) -> list[LinearSite]:
        if self._name is None:
            self.finalize()
        sites: list[LinearSite] = []
        self._collect_sites((), sites)
        return sites

    def _collect_sites(self, path: tuple[str, ...], out: list[LinearSite]) -> None:
        for key, child in self._children.items():
            child._collect_sites(path + (key,), out)


class Linear(Module):
    """y = x @ w (+ b): the quantizable site.

    Weight layout is ``(in_features, out_features)`` (the reference's MatMul
    convention; its StandarizeGemm pre-pass forces the same transB=0 layout at
    ``pre_passes/standarize_gemm.py:5-49``).
    """

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype=jnp.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = use_bias
        self.dtype = dtype
        # Tensor-parallel row-parallel marker: when set to a mesh axis name
        # (inside shard_map), the local partial product is psum'd over that
        # axis before the bias is added (the Megatron row-parallel schedule).
        self.tp_reduce: str | None = None

    @property
    def op_type(self) -> str:
        return "Gemm" if self.use_bias else "MatMul"

    def init(self, rng: jax.Array) -> dict:
        wkey, _ = jax.random.split(rng)
        # Truncated normal (sigma=0.1, clip 2.5 sigma) keeps quantization error
        # small in tests, mirroring the reference fixtures (test_quantize.py:20-22).
        w = 0.1 * jax.random.truncated_normal(
            wkey, -2.5, 2.5, (self.in_features, self.out_features)
        ).astype(self.dtype)
        params = {"w": w}
        if self.use_bias:
            params["b"] = jnp.zeros((self.out_features,), dtype=self.dtype)
        return params

    def _collect_sites(self, path: tuple[str, ...], out: list[LinearSite]) -> None:
        out.append(
            LinearSite(
                name=self._name if self._name else ".".join(path),
                op_type=self.op_type,
                param_path=path,
                in_features=self.in_features,
                out_features=self.out_features,
            )
        )

    def __call__(self, params, x, ctx: Context | None = None):
        from onnx_quantize_tpu.ops import quantized_matmul

        w = params["w"]
        b = params.get("b")
        # The stream dtype is captured BEFORE the prescale multiply: prescale
        # is stored f32, and `x * prescale` would otherwise promote a bf16
        # stream (and the cast-back below would then return f32 — re-creating
        # the f32-stream regression at every AWQ/SmoothQuant site).
        in_dtype = x.dtype
        prescale = params.get("prescale")
        if prescale is not None:
            # The folded SmoothQuant/AWQ input scale (the reference's inserted
            # Mul node, smooth_quant.py:76-89).
            x = (x * prescale).astype(in_dtype)

        if ctx is not None:
            ctx.collect(self._name, "input", x)

        if self.tp_reduce is not None:
            # Row-parallel: local matmul on the K-shard, one psum over the
            # model axis, bias added afterwards (exactly once, replicated).
            if isinstance(w, QTensor):
                y = quantized_matmul(x, w, None)
            else:
                y = jnp.matmul(x, w, preferred_element_type=jnp.float32)
            y = jax.lax.psum(y, self.tp_reduce)
            if b is not None:
                y = y + b
        elif isinstance(w, QTensor):
            y = quantized_matmul(x, w, b)
        else:
            y = jnp.matmul(x, w, preferred_element_type=jnp.float32)
            if b is not None:
                y = y + b

        # Accumulate in f32 (the QDQ chain and the tensor-core accumulator are f32),
        # but hand the ACTIVATION back in the caller's dtype. Without this the
        # first residual add promotes the whole stream to f32: attends over
        # the int8 KV cache run in f32 and every downstream matmul receives
        # f32 operands.
        # Identity on the f32 test paths.
        y = y.astype(in_dtype)

        if ctx is not None:
            ctx.collect(self._name, "output", y)
        return y


class Sequential(Module):
    """Chain of modules applied in order; children named by index."""

    def __init__(self, *layers: Module):
        super().__init__()
        self.layers = list(layers)
        for i, layer in enumerate(layers):
            setattr(self, str(i), layer)

    def __call__(self, params, x, ctx: Context | None = None):
        for i, layer in enumerate(self.layers):
            x = layer(params[str(i)], x, ctx=ctx)
        return x

"""Calibration: jit'd forwards with activation taps.

JAX replacement for the reference's ORT-based calibration runtime
(``/root/reference/src/onnx_quantize/core/_calibration/calibrate.py:204-382``).
Where the reference temporarily rewires graph outputs and runs an ORT session,
we run the model's own ``apply`` under ``jax.jit`` with a tap context — the
taps are returned as extra jit outputs, so XLA compiles one program per batch
shape and the forward runs on the configured backend (cpu, gpu, or JAX's
default).

Behavioral parity:
  * random calibration data fallback (seeded rng; int inputs drawn in
    [0, 100) as conservative token ids) — ``calibrate.py:127-147``,
  * mini-batching with excess-sample drop — ``calibrate.py:150-172``,
  * multi-input models require dict data — ``calibrate.py:228-236``,
  * static input/output qparams per plan entry via the calibrator —
    ``calibrate.py:254-285``,
  * raw concatenated inputs captured for GPTQ/AWQ/SmoothQuant —
    ``calibrate.py:288-307``,
  * backend availability check — ``calibrate.py:184-201``; where the
    reference warns and falls back to the CPU, an unavailable backend is an
    error here, so calibration never moves to the host unasked.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.calibration.base import Calibrator
from onnx_quantize_tpu.calibration.factory import get_calibrator
from onnx_quantize_tpu.core.numerics import compute_qparams
from onnx_quantize_tpu.core.qconfig import Backend, QActivationArgs, QConfig
from onnx_quantize_tpu.nn.module import Context, InputSpec, Module
from onnx_quantize_tpu.plan import QuantPlan

logger = get_logger(__name__)

__all__ = ["calibrate_model", "collect_activations"]


def _generate_random_calibration_data(
    num_samples: int, input_specs: list[InputSpec]
) -> np.ndarray | dict[str, np.ndarray]:
    logger.info("Generating random calibration data as None was provided.")
    rng = np.random.default_rng(0)

    def _random_array(spec: InputSpec) -> np.ndarray:
        shape = (num_samples, *spec.shape)
        dtype = np.dtype(spec.dtype)
        if np.issubdtype(dtype, np.integer):
            # Conservative range — valid as token IDs for typical vocab sizes
            # and as attention-mask values.
            return rng.integers(0, 100, size=shape, dtype=dtype)
        return rng.standard_normal(size=shape).astype(dtype)

    if len(input_specs) == 1:
        return _random_array(input_specs[0])
    return {spec.name: _random_array(spec) for spec in input_specs}


def _prepare_calibration_data(
    calibration_data: np.ndarray, batch_size: int, num_samples: int
) -> np.ndarray:
    """Split into full batches, dropping excess samples (ref semantics)."""
    total = calibration_data.shape[0]
    if num_samples > total:
        num_samples = total
    calibration_data = calibration_data[:num_samples]

    if batch_size >= num_samples:
        return calibration_data.reshape((1, num_samples, *calibration_data.shape[1:]))

    num_batches = num_samples // batch_size
    calibration_data = calibration_data[: num_batches * batch_size]
    return calibration_data.reshape(
        (num_batches, batch_size, *calibration_data.shape[1:])
    )


def _resolve_backend(backend: Backend) -> str:
    """The JAX platform calibration forwards run on; raises if it is absent."""
    if backend == Backend.DEFAULT:
        return jax.default_backend()
    try:
        jax.devices(backend.value)
    except RuntimeError as exc:
        available = sorted({d.platform for d in jax.devices()})
        raise ValueError(
            f"Calibration backend '{backend.value}' is not available "
            f"(available platforms: {available})"
        ) from exc
    return backend.value


def collect_activations(
    model: Module,
    params,
    plan: QuantPlan,
    calibration_data,
    num_samples: int,
    batch_size: int,
    backend: Backend,
    tap_inputs: bool,
    tap_outputs: bool,
) -> list[dict[str, dict[str, np.ndarray]]]:
    """Run batched calibration forwards; return per-batch tap dictionaries."""
    model.finalize()
    input_specs = model.input_specs
    if calibration_data is None:
        if input_specs is None:
            raise ValueError(
                "Model declares no input_specs; pass calibration_data explicitly "
                "or set Module.input_specs for random-data calibration."
            )
        calibration_data = _generate_random_calibration_data(num_samples, input_specs)

    if input_specs is not None and len(input_specs) > 1:
        if not isinstance(calibration_data, dict):
            raise ValueError(
                "Calibration data must be a dict mapping input names to arrays "
                "for multi-input models."
            )

    if not isinstance(calibration_data, dict):
        first = input_specs[0].name if input_specs else "input"
        calibration_data = {first: np.asarray(calibration_data)}

    input_order = (
        [s.name for s in input_specs] if input_specs else list(calibration_data)
    )
    batched = {
        name: _prepare_calibration_data(np.asarray(data), batch_size, num_samples)
        for name, data in calibration_data.items()
    }
    num_batches = len(next(iter(batched.values())))

    tap_names = {entry.name for entry in plan}
    platform = _resolve_backend(backend)

    def fwd(p, *inputs):
        ctx = Context(
            taps={}, tap_inputs=tap_inputs, tap_outputs=tap_outputs, tap_names=tap_names
        )
        model(p, *inputs, ctx=ctx)
        return ctx.taps

    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        def tqdm(x, **kw):
            return x

    with jax.default_device(jax.devices(platform)[0]):
        jit_fwd = jax.jit(fwd)
        activations = []
        for i in tqdm(range(num_batches), desc="Calibrating"):
            feeds = [jnp.asarray(batched[name][i]) for name in input_order]
            taps = jax.device_get(jit_fwd(params, *feeds))
            activations.append(taps)
    return activations


def _set_entry_qparams(
    plan: QuantPlan,
    activations: list[dict[str, dict[str, np.ndarray]]],
    calibrator: Calibrator,
    qargs: QActivationArgs,
    kind: str,  # "input" | "output"
) -> None:
    for batch in activations:
        for site_name, taps in batch.items():
            if kind in taps:
                calibrator.collect(f"{site_name}::{kind}", taps[kind])

    for entry in plan:
        key = f"{entry.name}::{kind}"
        if key not in calibrator.data:
            continue
        rmin, rmax = calibrator.compute_range(key)
        scale, zp = compute_qparams(
            rmin,
            rmax,
            qargs.dtype,
            qargs.symmetric,
            qargs.reduce_range,
            qargs.scale_dtype,
            qargs.zp_dtype,
        )
        setattr(entry, f"{kind}_scale", np.asarray(scale))
        setattr(entry, f"{kind}_zero_point", np.asarray(zp))


def _capture_raw_inputs(
    plan: QuantPlan, activations: list[dict[str, dict[str, np.ndarray]]]
) -> None:
    """Concatenate raw input activations per site (GPTQ/AWQ/SmoothQuant feed)."""
    collected: dict[str, list[np.ndarray]] = {}
    for batch in activations:
        for site_name, taps in batch.items():
            if "input" in taps:
                collected.setdefault(site_name, []).append(np.asarray(taps["input"]))

    for entry in plan:
        if entry.name in collected:
            entry.captured_input = np.concatenate(collected[entry.name], axis=0)


def calibrate_model(model: Module, params, plan: QuantPlan, qconfig: QConfig) -> None:
    """Calibrate: fill plan entries with act qparams and/or raw captured inputs."""
    calibrate_inputs = (
        qconfig.input_activations is not None and qconfig.input_activations.is_static
    )
    calibrate_outputs = (
        qconfig.output_activations is not None and qconfig.output_activations.is_static
    )
    preprocessing_needs_inputs = any(
        pre.requires_calibration for pre in qconfig.preprocessors
    )
    algorithm_needs_inputs = (
        qconfig.weights is not None and qconfig.weights.algorithm.requires_calibration
    )

    tap_inputs = calibrate_inputs or algorithm_needs_inputs or preprocessing_needs_inputs
    tap_outputs = calibrate_outputs
    if not (tap_inputs or tap_outputs):
        return

    cp = qconfig.calibration_params
    activations = collect_activations(
        model,
        params,
        plan,
        qconfig.calibration_data,
        num_samples=cp.num_samples,
        batch_size=cp.batch_size,
        backend=cp.backend if isinstance(cp.backend, Backend) else Backend(cp.backend),
        tap_inputs=tap_inputs,
        tap_outputs=tap_outputs,
    )

    method = cp.method if isinstance(cp.method, str) else cp.method.value
    if method == "percentile":
        calibrator = get_calibrator(cp.method, percentile=cp.percentile, momentum=cp.momentum)
    else:
        calibrator = get_calibrator(cp.method, momentum=cp.momentum)

    if calibrate_inputs:
        _set_entry_qparams(plan, activations, calibrator, qconfig.input_activations, "input")
    if calibrate_outputs:
        _set_entry_qparams(plan, activations, calibrator, qconfig.output_activations, "output")
    if algorithm_needs_inputs or preprocessing_needs_inputs:
        _capture_raw_inputs(plan, activations)

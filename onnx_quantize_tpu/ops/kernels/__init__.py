"""Hand-written GPU kernels (Pallas on the Triton route).

Only kernels that beat what XLA makes of the plain jnp version, end to end on
the card, live here; :mod:`onnx_quantize_tpu.ops.dispatch` decides when each
one runs.
"""

"""Device mesh construction.

The JAX replacement for the reference's ExecutionProvider selection
(``core/_calibration/base.py:12-32``): instead of picking a CPU/CUDA session,
we lay devices out as a ``jax.sharding.Mesh`` with ``data`` (batch) and
``model`` (tensor-parallel) axes. Shardings annotated against this mesh make
XLA insert the all-gather/reduce-scatter collectives (SURVEY.md §5,
"Distributed communication backend"). The mesh follows the algorithm, not a
link topology: the GPUs of one host are joined all to all.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "replicated"]


def make_mesh(
    model_parallel: int | None = None,
    devices=None,
    axis_names: tuple[str, str] = ("data", "model"),
) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    ``model_parallel`` defaults to the largest power-of-two divisor of the
    device count up to 8 (one host's GPUs); override it to put the rest on
    ``data``.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if model_parallel is None:
        model_parallel = 1
        for candidate in (8, 4, 2):
            if n % candidate == 0:
                model_parallel = candidate
                break
    assert n % model_parallel == 0, (n, model_parallel)
    grid = np.asarray(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, axis_names)


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch) dim over ``data``; replicate the rest."""
    return NamedSharding(mesh, P("data", *(None,) * (ndim - 1)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

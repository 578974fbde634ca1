"""The device a measurement runs on: checked, named, never assumed."""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "card_name_and_power_limit", "device_record"]


def require_gpu():
    """The first JAX device, which must be a GPU; exits non-zero otherwise
    (a measurement path never falls back to the CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs only on the GPU"
        )
    return dev


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, read in a child
    process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}

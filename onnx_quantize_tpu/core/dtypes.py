"""Quantization dtype system.

JAX re-design of the reference dtype layer
(``/root/reference/src/onnx_quantize/core/_dtypes.py:8-70``): the same three range
tables (full asymmetric, symmetric, reduced) and the same string-parsing surface,
but carrying JAX dtypes (``jnp.int4``/``jnp.uint4`` are first-class JAX dtypes) in
addition to numpy container dtypes used on the host-side planning path.
"""

from __future__ import annotations

import enum

import jax.numpy as jnp
import ml_dtypes
import numpy as np

__all__ = ["QuantType"]


# Full asymmetric ranges (ref: _dtypes.py:8-15).
_DTYPE_RANGES: dict[str, tuple[int, int]] = {
    "uint4": (0, 15),
    "int4": (-8, 7),
    "uint8": (0, 255),
    "int8": (-128, 127),
    "uint32": (0, 2**32 - 1),
    "int32": (-(2**31), 2**31 - 1),
}

# Symmetric ranges for signed types (ref: _dtypes.py:17-21).
_SYMMETRIC_RANGES: dict[str, tuple[int, int]] = {
    "int4": (-7, 7),
    "int8": (-127, 127),
    "int32": (-(2**31 - 1), 2**31 - 1),
}

# Reduced ranges (ref: _dtypes.py:23-30). Note int8 is (-64, 64), not (-64, 63).
_REDUCED_RANGES: dict[str, tuple[int, int]] = {
    "uint4": (0, 7),
    "int4": (-4, 3),
    "uint8": (0, 127),
    "int8": (-64, 64),
    "uint32": (0, 2**31 - 1),
    "int32": (-(2**30), 2**30),
}

# numpy dtypes as stored in checkpoints / used by host-side planning math.
_NP_DTYPES = {
    "int4": np.dtype(ml_dtypes.int4),
    "uint4": np.dtype(ml_dtypes.uint4),
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "int32": np.dtype(np.int32),
    "uint32": np.dtype(np.uint32),
}

# JAX dtypes used on-device. int4/uint4 are native jnp dtypes.
_JNP_DTYPES = {
    "int4": jnp.int4,
    "uint4": jnp.uint4,
    "int8": jnp.int8,
    "uint8": jnp.uint8,
    "int32": jnp.int32,
    "uint32": jnp.uint32,
}

# 8/32-bit container dtype used for unpacked 4-bit arithmetic.
_CONTAINER_DTYPES = {
    "int4": np.dtype(np.int8),
    "uint4": np.dtype(np.uint8),
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "int32": np.dtype(np.int32),
    "uint32": np.dtype(np.uint32),
}

_BITWIDTH = {"int4": 4, "uint4": 4, "int8": 8, "uint8": 8, "int32": 32, "uint32": 32}


class QuantType(enum.Enum):
    """Enumeration of supported quantization element types."""

    QInt4 = "int4"
    QUInt4 = "uint4"
    QInt8 = "int8"
    QUInt8 = "uint8"
    QInt32 = "int32"
    QUInt32 = "uint32"

    @classmethod
    def from_string(cls, value: str) -> "QuantType":
        key = value.lower().strip()
        for member in cls:
            if member.value == key:
                return member
        raise ValueError(
            f"Invalid quantization type '{value}'. "
            f"Expected one of: {', '.join(m.value for m in cls)}"
        )

    @property
    def np_dtype(self) -> np.dtype:
        """Numpy dtype (ml_dtypes int4/uint4 for 4-bit, mirroring the reference)."""
        return _NP_DTYPES[self.value]

    @property
    def jnp_dtype(self):
        """On-device JAX dtype (native jnp.int4/uint4 for 4-bit)."""
        return _JNP_DTYPES[self.value]

    @property
    def container_dtype(self) -> np.dtype:
        """8/32-bit numpy container used for unpacked 4-bit arithmetic."""
        return _CONTAINER_DTYPES[self.value]

    @property
    def bitwidth(self) -> int:
        return _BITWIDTH[self.value]

    @property
    def is_signed(self) -> bool:
        return not self.value.startswith("u")

    def qrange(self, is_symmetric: bool, reduce_range: bool = False) -> tuple[int, int]:
        """Return the (qmin, qmax) integer range.

        Mirrors the reference lookup order (``_dtypes.py:61-70``): reduced range
        wins over symmetric; symmetric applies only to signed types.
        """
        if reduce_range:
            return _REDUCED_RANGES[self.value]
        if is_symmetric and self.value in _SYMMETRIC_RANGES:
            return _SYMMETRIC_RANGES[self.value]
        return _DTYPE_RANGES[self.value]

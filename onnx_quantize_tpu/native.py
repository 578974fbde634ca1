"""ctypes bindings for the native host library (``native/oqt_native.cpp``).

Builds the shared object on first use when a C++ toolchain is present
(``make -C native``) — and rebuilds it when it is older than its source, since
a library built on another machine may not match this one — and falls back to
pure numpy when it cannot — import never fails. The numpy fallbacks are the same functions the rest of the
framework already uses, so behavior is identical either way.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from onnx_quantize_tpu._logging import get_logger

logger = get_logger(__name__)

__all__ = ["get_lib", "build_error", "pack_group_pairs", "unpack_group_pairs",
           "minmax_rows"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "liboqt_native.so"
_SRC_PATH = _NATIVE_DIR / "oqt_native.cpp"
_LIB = None
_TRIED = False


_BUILD_ERROR: str | None = None


def _build() -> bool:
    """``make -C native``, else the compiler directly without OpenMP or
    ``-march=native`` (a machine may lack make or libgomp)."""
    global _BUILD_ERROR
    cxx = os.environ.get("CXX", "c++")
    commands = [
        ["make", "-C", str(_NATIVE_DIR)],
        [cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(_LIB_PATH),
         str(_SRC_PATH)],
    ]
    for cmd in commands:
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            if _LIB_PATH.exists():
                _BUILD_ERROR = None
                return True
        except Exception as exc:  # toolchain missing / build failure
            detail = getattr(exc, "stderr", b"") or b""
            _BUILD_ERROR = f"{cmd[0]}: {exc} {detail.decode(errors='replace')[-300:]}"
            logger.debug("native build step failed: %s", _BUILD_ERROR)
    return False


def build_error() -> str | None:
    """Why the last build attempt failed (None if it did not)."""
    return _BUILD_ERROR


def needs_build(lib_path: Path = _LIB_PATH, src_path: Path = _SRC_PATH) -> bool:
    """True when the library is missing or older than its source."""
    if not lib_path.exists():
        return True
    return src_path.exists() and lib_path.stat().st_mtime < src_path.stat().st_mtime


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("OQT_DISABLE_NATIVE"):
        return None
    if needs_build() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.oqt_pack_group_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.oqt_unpack_group_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.oqt_minmax_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.oqt_minmax_all.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _LIB = lib
        logger.debug("native library loaded from %s", _LIB_PATH)
    except OSError as exc:
        logger.debug("native library load failed: %s", exc)
        _LIB = None
    return _LIB


def pack_group_pairs(q: np.ndarray, gs: int, n_groups_pad: int) -> np.ndarray | None:
    """Native group-pair nibble pack; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.int8)
    K, N = q.shape
    out = np.empty((n_groups_pad * gs // 2, N), dtype=np.uint8)
    lib.oqt_pack_group_pairs(
        q.ctypes.data, out.ctypes.data, K, N, gs, n_groups_pad
    )
    return out


def unpack_group_pairs(packed: np.ndarray, K: int, N: int, gs: int,
                       signed: bool) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty((K, N), dtype=np.int8)
    lib.oqt_unpack_group_pairs(
        packed.ctypes.data, out.ctypes.data, K, N, gs, int(signed)
    )
    return out


def minmax_rows(x: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows, cols = x.shape
    mins = np.empty((rows,), np.float32)
    maxs = np.empty((rows,), np.float32)
    lib.oqt_minmax_rows(x.ctypes.data, mins.ctypes.data, maxs.ctypes.data, rows, cols)
    return mins, maxs

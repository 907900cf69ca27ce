"""ctypes bindings for the native pcmops library (native/pcmops.c).

Builds libpcmops.so on first use when a C compiler is available (the .so is
cached next to the source); every binding has a numpy fallback so the
framework works without a toolchain.  Used by the realtime playback path,
where per-chunk device dispatch latency (~0.1 ms) would dominate the work
(a 33 ms chunk K-way add) — bulk DSP stays on the device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libpcmops.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        src = os.path.join(_NATIVE_DIR, "pcmops.c")
        try:
            if (not os.path.exists(_SO_PATH)
                    or os.path.getmtime(_SO_PATH) < os.path.getmtime(src)):
                subprocess.run(
                    ["cc", "-O3", "-fPIC", "-shared", "-std=c11",
                     "-o", _SO_PATH, src, "-lm"],
                    check=True, capture_output=True, timeout=60)
            lib = ctypes.CDLL(_SO_PATH)
        except Exception:
            return None
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.sat_add_i16.argtypes = [i16p, i16p, i16p, ctypes.c_size_t]
        lib.sat_add_i32.argtypes = [ctypes.POINTER(ctypes.c_int32)] * 3 + [ctypes.c_size_t]
        lib.mix_k_i16.argtypes = [ctypes.POINTER(i16p), ctypes.c_int, i16p,
                                  ctypes.c_size_t]
        lib.mul_floor_i16.argtypes = [i16p, ctypes.c_float, i16p, ctypes.c_size_t]
        lib.peak_i16.argtypes = [i16p, ctypes.c_size_t]
        lib.peak_i16.restype = ctypes.c_int32
        lib.mean_square_i16.argtypes = [i16p, ctypes.c_size_t]
        lib.mean_square_i16.restype = ctypes.c_double
        lib.vu_i16.argtypes = [i16p, ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def sat_add_i16(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Saturating int16 add (contiguous arrays of equal size)."""
    lib = _load()
    a = np.ascontiguousarray(a, np.int16)
    b = np.ascontiguousarray(b, np.int16)
    if lib is None:
        return np.clip(a.astype(np.int32) + b.astype(np.int32),
                       -32768, 32767).astype(np.int16)
    out = np.empty_like(a)
    lib.sat_add_i16(_i16p(a), _i16p(b), _i16p(out), a.size)
    return out


def mix_k_i16(bufs: Sequence[np.ndarray]) -> np.ndarray:
    """Sum K int16 chunks in int32, saturate once (RealTimeMixer hot path)."""
    lib = _load()
    bufs = [np.ascontiguousarray(b, np.int16) for b in bufs]
    if lib is None:
        acc = np.zeros(bufs[0].shape, np.int32)
        for b in bufs:
            acc += b
        return np.clip(acc, -32768, 32767).astype(np.int16)
    out = np.empty_like(bufs[0])
    arr_t = ctypes.POINTER(ctypes.c_int16) * len(bufs)
    ptrs = arr_t(*[_i16p(b) for b in bufs])
    lib.mix_k_i16(ptrs, len(bufs), _i16p(out), out.size)
    return out


def mul_floor_i16(a: np.ndarray, factor: float) -> np.ndarray:
    """f32-spec scale: floor(f32(a) * f32(factor)), clamp."""
    lib = _load()
    a = np.ascontiguousarray(a, np.int16)
    if lib is None:
        p = a.astype(np.float32) * np.float32(factor)
        return np.clip(np.floor(p.astype(np.float64)), -32768, 32767).astype(np.int16)
    out = np.empty_like(a)
    lib.mul_floor_i16(_i16p(a), ctypes.c_float(factor), _i16p(out), a.size)
    return out


def vu_i16(stereo: np.ndarray) -> Tuple[int, int, float, float]:
    """Interleaved stereo [n, 2] -> (peak_l, peak_r, ms_l, ms_r)."""
    lib = _load()
    a = np.ascontiguousarray(stereo, np.int16)
    n = a.shape[0]
    if lib is None:
        l, r = a[:, 0].astype(np.float64), a[:, 1].astype(np.float64)
        return (int(np.abs(a[:, 0].astype(np.int32)).max(initial=0)),
                int(np.abs(a[:, 1].astype(np.int32)).max(initial=0)),
                float((l * l).mean()) if n else 0.0,
                float((r * r).mean()) if n else 0.0)
    peaks = (ctypes.c_int32 * 2)()
    ms = (ctypes.c_double * 2)()
    lib.vu_i16(_i16p(a), n, peaks, ms)
    return int(peaks[0]), int(peaks[1]), float(ms[0]), float(ms[1])

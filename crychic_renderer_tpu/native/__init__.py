"""Native (C++) asset pipeline, bound via ctypes.

Compiled from asset_pipeline.cpp on first use with g++ (cached as
libcrychic_assets.so next to the source; the library is not committed).
Falls back to None if no toolchain is available — callers keep their
pure-numpy paths (io/dds.py, io/mesh_txt.py, ops/ssao.py).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "asset_pipeline.cpp")
_LIB = os.path.join(_DIR, "libcrychic_assets.so")

_lib = None
_tried = False


def _build() -> bool:
    try:
        if (os.path.exists(_LIB)
                and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
            return True
        # build to a private name and rename: concurrent processes (test
        # workers) never load a half-written library
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
             "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False


def get_lib():
    """Returns the loaded ctypes library or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.decode_bc1.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.decode_bc2.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.decode_bc3.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.mesh_txt_counts.argtypes = [ctypes.c_char_p, i32p, i32p]
    lib.mesh_txt_counts.restype = ctypes.c_int
    lib.mesh_txt_parse.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int,
                                   i32p, ctypes.c_int]
    lib.mesh_txt_parse.restype = ctypes.c_int
    lib.msvc_random_texture.argtypes = [f32p, ctypes.c_int, ctypes.c_uint32,
                                        ctypes.c_int]
    _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_bc1(data: bytes, width: int, height: int):
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((height, width, 4), dtype=np.uint8)
    lib.decode_bc1(_u8(buf), width, height, _u8(out))
    return out


def decode_bc2(data: bytes, width: int, height: int):
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((height, width, 4), dtype=np.uint8)
    lib.decode_bc2(_u8(buf), width, height, _u8(out))
    return out


def decode_bc3(data: bytes, width: int, height: int):
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((height, width, 4), dtype=np.uint8)
    lib.decode_bc3(_u8(buf), width, height, _u8(out))
    return out


def parse_mesh_txt(path: str):
    """Returns (pos_nrm (V, 6) f32, indices (3T,) i32) or None."""
    lib = get_lib()
    if lib is None:
        return None
    vc = ctypes.c_int32(0)
    tc = ctypes.c_int32(0)
    if lib.mesh_txt_counts(path.encode(), ctypes.byref(vc),
                           ctypes.byref(tc)) != 0:
        return None
    v = np.empty((vc.value, 6), dtype=np.float32)
    idx = np.empty(tc.value * 3, dtype=np.int32)
    rc = lib.mesh_txt_parse(
        path.encode(),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), vc.value,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), tc.value)
    if rc != 0:
        return None
    return v, idx


def msvc_random_texture(size: int = 256, seed: int = 1,
                        skip_draws: int = 14):
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((size, size, 3), dtype=np.float32)
    lib.msvc_random_texture(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        seed, skip_draws)
    return out

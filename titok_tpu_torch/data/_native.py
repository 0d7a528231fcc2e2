"""Build the port's host libraries with ``g++`` at first use and load them.

Two shared libraries from ``titok_tpu_torch/native/``, each with a plain C
interface loaded through ``ctypes``:

- ``pack``: ``packer.cpp`` (``pk_patchify_normalize``), no dependency, so it
  builds wherever ``g++`` does;
- ``av``: ``video_decoder.cpp`` and ``frame_resize.cpp`` (decode, the mpeg4
  encoder, the swscale crop and bicubic resize), linked against libav
  (libavformat, libavcodec, libavutil, libswscale) through ``pkg-config``.

    g++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared $(pkg-config --cflags ...) \\
        -o build/native/lib<name>_<hash>.so <sources> $(pkg-config --libs ...)

The libraries go to ``build/native/`` beside the package (listed in
``.gitignore``), named by a hash of the sources, the flags and
pkg-config's flags, so an unchanged library is built once. A failed build
or load raises :class:`NativeLibraryError` with the compiler's or
pkg-config's message; nothing falls back to another implementation.
``-ffp-contract=off`` keeps the packer's ``x * (2/255) - 1`` two roundings,
equal bit for bit to ``ops/patchify.py:decode_rows`` on any host compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "native")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"]
LIBAV_PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")
# library name -> (sources under NATIVE_DIR, pkg-config packages)
LIBRARIES = {
    "pack": (("packer.cpp",), ()),
    "av": (("video_decoder.cpp", "frame_resize.cpp"), LIBAV_PACKAGES),
}

_u8p = ctypes.POINTER(ctypes.c_uint8)
_int = ctypes.c_int
_SIGNATURES = {
    "pack": {
        "pk_patchify_normalize": (_int, [_u8p, _int, _int, _int, _int, _int, _int, _int,
                                         ctypes.POINTER(ctypes.c_float)]),
    },
    "av": {
        "vd_open_file": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p, _int]),
        "vd_open_bytes": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64,
                                            ctypes.c_char_p, _int]),
        "vd_num_frames": (ctypes.c_int64, [ctypes.c_void_p]),
        "vd_fps": (ctypes.c_double, [ctypes.c_void_p]),
        "vd_width": (_int, [ctypes.c_void_p]),
        "vd_height": (_int, [ctypes.c_void_p]),
        "vd_get_batch": (_int, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), _int, _u8p,
                                ctypes.c_char_p, _int]),
        "vd_close": (None, [ctypes.c_void_p]),
        "vd_encode_video": (_int, [ctypes.c_char_p, _u8p, _int, _int, _int, ctypes.c_double,
                                   ctypes.c_char_p, ctypes.c_char_p, _int]),
        "fr_resize_frames": (_int, [_u8p, ctypes.c_int64, _int, _int, _int, _int, _int, _int,
                                    _u8p, _int, _int]),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# library name -> seconds g++ took to build it in this process (0.0: an
# earlier build of the same sources and flags was found under BUILD_DIR)
build_seconds: dict[str, float] = {}


class NativeLibraryError(RuntimeError):
    """A host library that cannot be built or loaded."""


def _run(cmd: list[str], what: str) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # the program itself is missing
        raise NativeLibraryError(f"{what}: {e}") from e
    if res.returncode != 0:
        raise NativeLibraryError(f"{what} failed ({' '.join(cmd)}):\n"
                                 f"{(res.stdout + res.stderr).strip()}")
    return res.stdout


def libav_versions() -> dict[str, str]:
    """``pkg-config --modversion`` of each libav package; raises
    :class:`NativeLibraryError` with pkg-config's message where one is
    missing."""
    out = _run(["pkg-config", "--modversion", *LIBAV_PACKAGES], "pkg-config")
    return dict(zip(LIBAV_PACKAGES, out.split()))


def _build(name: str) -> str:
    """Path of library ``name``, built first unless a build with the same
    hash exists."""
    sources, packages = LIBRARIES[name]
    paths = [os.path.join(NATIVE_DIR, s) for s in sources]
    for p in paths:
        if not os.path.exists(p):
            raise NativeLibraryError(f"library {name!r}: no source {p}")
    cflags, libs = [], []
    if packages:
        cflags = _run(["pkg-config", "--cflags", *packages], "pkg-config").split()
        libs = _run(["pkg-config", "--libs", *packages], "pkg-config").split()
    h = hashlib.sha256(" ".join(CXX_FLAGS + cflags + libs).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        build_seconds[name] = 0.0
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    _run(["g++", *CXX_FLAGS, *cflags, "-o", tmp, *paths, *libs], f"g++ build of {name!r}")
    os.replace(tmp, path)  # atomic: another process never loads a partial file
    build_seconds[name] = time.perf_counter() - t0
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``"pack"`` or ``"av"``), built first if
    needed, its functions' argument and result types declared."""
    with _lock:
        if name not in _libs:
            path = _build(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeLibraryError(f"cannot load {path}: {e}") from e
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype, f.argtypes = restype, argtypes
            _libs[name] = lib
        return _libs[name]

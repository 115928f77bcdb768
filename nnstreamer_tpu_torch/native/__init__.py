"""The native runtime core: the C++ frame queue, its build and its codes.

The port's copy of the JAX package's ``native`` package.
``frame_queue.cpp`` is built with the toolchain's ``g++`` (``-O2 -std=c++17
-shared -fPIC -pthread``, no dependencies) at first use, into
``build/nnstreamer_tpu_torch/`` under the checkout root beside the CUDA
kernels (``ops/build.py``), under a name that carries a hash of the source
and the flags: an edited source rebuilds, an unchanged one loads from disk.
:mod:`.queue` binds it with ctypes (:class:`~.queue.NativeFrameQueue`) and
keeps the pure-Python twin (:class:`~.queue.PyFrameQueue`).

``[common] native_runtime`` (``NNSTPU_COMMON_NATIVE_RUNTIME``, on by
default, as in the JAX package) picks the native queue.  The JAX package
falls back to the twin without a word when the build or the load fails; the
port does not: with the switch on, a failed build raises
(:class:`NativeBuildError`), and only ``native_runtime=off`` picks the twin.

The status codes are the C++ queue's (``frame_queue.cpp``), shared by both
queues.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "frame_queue.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nnstreamer_tpu_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

# status codes (frame_queue.cpp's)
OK = 0
OK_DROPPED_OLDEST = 1
DROPPED_INCOMING = 2
SHUTDOWN = -1
TIMEOUT = -2

EVENT_BIT = 1 << 63

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The C++ frame queue did not build or load, with the native runtime on."""


def lib_path(src: Optional[Path] = None) -> Path:
    """Where the library of ``src`` (default: ``frame_queue.cpp``) lands."""
    src = Path(src) if src is not None else SOURCE
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnns_runtime-{digest}.so"


def build(src: Optional[Path] = None) -> Path:
    """Compile ``src`` (default: ``frame_queue.cpp``) unless its library is
    on disk; returns the library's path.  Raises :class:`NativeBuildError`
    with the compiler's output when ``g++`` is missing or fails."""
    src = Path(src) if src is not None else SOURCE
    out = lib_path(src)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found: the native frame queue needs a C++ compiler "
                               "(or [common] native_runtime=off for the Python queue)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed for {src.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.nns_queue_new.argtypes = [ctypes.c_uint64]
    lib.nns_queue_new.restype = ctypes.c_void_p
    lib.nns_queue_free.argtypes = [ctypes.c_void_p]
    lib.nns_queue_free.restype = None
    lib.nns_queue_shutdown.argtypes = [ctypes.c_void_p]
    lib.nns_queue_shutdown.restype = None
    lib.nns_queue_len.argtypes = [ctypes.c_void_p]
    lib.nns_queue_len.restype = ctypes.c_int64
    lib.nns_queue_push.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.nns_queue_push.restype = ctypes.c_int
    lib.nns_queue_pop.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.nns_queue_pop.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises
    :class:`NativeBuildError` when it cannot be built or loaded.

    The build runs outside the lock (ROADMAP C23): ``g++`` takes about a
    second, which the JAX package spends holding its lock, so every other
    thread making its first queue waits behind the compiler.  Two first
    users may both compile here; each writes its own temporary file and
    renames it into place, so either result loads."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    with _lock:
        if _lib is None:
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, AttributeError) as exc:
                raise NativeBuildError(f"cannot load {path}: {exc}") from exc
    return _lib


def enabled() -> bool:
    """``[common] native_runtime``: the native queue unless switched off."""
    from ..conf import conf

    return conf.get_bool("common", "native_runtime", True)

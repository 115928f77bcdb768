"""Build and locate the port's native C application API library.

``libnnstreamer_tpu_torch_capi.so`` is the port's copy of the JAX package's
``libnnstreamer_tpu_capi.so``, the analog of the reference's
``libcapi-nnstreamer.so`` (``api/capi/meson.build``): a C ABI
(``nnstreamer-capi.h``) for apps written in C or C++, implemented by
embedding CPython (``capi.cpp``), which imports
``nnstreamer_tpu_torch.api.capi_glue``.  :func:`build_capi` compiles it
with ``g++`` at first use into ``build/nnstreamer_tpu_torch/capi/`` under
the checkout root; ``capi_smoke.c`` beside it is a plain C program that
drives the whole ABI (:func:`build_smoke`).  Embedding needs a shared
``libpython`` (``sysconfig``'s ``Py_ENABLE_SHARED``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "capi.cpp"
HEADER = _HERE / "nnstreamer-capi.h"
SMOKE_SRC = _HERE / "capi_smoke.c"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "nnstreamer_tpu_torch" / "capi"
LIB_NAME = "libnnstreamer_tpu_torch_capi.so"

_lock = threading.Lock()


def python_link_flags() -> list:
    """Include and link flags for embedding this interpreter."""
    inc = sysconfig.get_config_var("INCLUDEPY")
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    return [f"-I{inc}", f"-L{libdir}", f"-lpython{ver}", f"-Wl,-rpath,{libdir}"]


def build_key() -> str:
    """Hash of the sources and of the interpreter's ABI: a library built
    for another Python, platform or libpython is rebuilt, never loaded."""
    abi = "|".join([f"{sys.version_info.major}.{sys.version_info.minor}",
                    sysconfig.get_platform(), " ".join(python_link_flags())])
    return hashlib.sha256(_SRC.read_bytes() + HEADER.read_bytes() + abi.encode()).hexdigest()


def _compile(cmd: list, out: Path) -> None:
    """Run the compiler into a temporary file of this thread's own, then
    move it into place (another thread or process may build the same
    file)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n"
                           f"{proc.stderr.decode(errors='replace')}")
    os.replace(tmp, out)


def build_capi(build_dir: Path = BUILD_DIR) -> str:
    """Compile (once per key) and return the path of the library.

    The compiler runs outside the lock (ROADMAP C25): the JAX package holds
    its lock around ``g++``, so every other thread that asks for the
    library waits behind the compiler.  Two first callers may both compile;
    each writes its own temporary file, renamed into place, and the stamp
    is written under the lock."""
    so = Path(build_dir) / LIB_NAME
    stamp = so.with_name(so.name + ".stamp")
    key = build_key()
    with _lock:
        if so.exists() and stamp.exists() and stamp.read_text().strip() == key:
            return str(so)
    _compile(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SRC)]
             + python_link_flags(), so)
    with _lock:
        stamp.write_text(key)
    return str(so)


def build_smoke(out: Path, build_dir: Path = BUILD_DIR) -> str:
    """Compile ``capi_smoke.c`` against the library into ``out``."""
    lib = build_capi(build_dir)
    _compile(["g++", "-O1", str(SMOKE_SRC), f"-I{_HERE}", lib,
              f"-Wl,-rpath,{os.path.dirname(lib)}"] + python_link_flags(), Path(out))
    return str(out)

"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source in ``csrc/`` becomes one shared library with a plain C entry
point, compiled for Hopper (``sm_90a``) at first use into
``build/nnstreamer_tpu_torch/`` under the checkout root.  The file name
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads from disk.  :func:`build_all` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nnstreamer_tpu_torch"
SOURCES = ("fused_arith", "int8_matmul", "nms_keep")

# -fmad=false keeps nvcc from contracting a*b+c into one rounding: the
# kernels must agree bit for bit with their plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _source(name: str, src: Optional[Path]) -> Path:
    return Path(src) if src is not None else CSRC / f"{name}.cu"


def lib_path(name: str, src: Optional[Path] = None) -> Path:
    code = _source(name, src).read_bytes()
    digest = hashlib.sha256(code + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, src: Optional[Path] = None):
    """Start nvcc for one source; None when the library is already built."""
    out = lib_path(name, src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name, src))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names: List[str] = SOURCES) -> Dict[str, str]:
    """Build every kernel library, one nvcc per source in parallel.
    Returns each newly built source's compiler output (ptxas -v report)."""
    jobs = {n: _start(n) for n in names}
    logs = {}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            logs[n] = _finish(n, job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str, src: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or for the source file
    ``src``, built under ``name``), built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name, src)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(lib_path(name, src)))
            _LIBS[name] = lib
        return lib

"""Runtime configuration and external plugins: the JAX package's ``conf.py``.

A knob ``[section] key`` is looked up in this order:

1. the env var ``NNSTPU_<SECTION>_<KEY>`` (e.g. ``NNSTPU_SEGMENT_ENABLED``),
   or a short spelling of :data:`SHORT_ENV` (``NNSTPU_PLUGIN_PATH``);
2. an ini file (``configparser`` flavor), the first that exists of: an
   explicit path, ``$NNSTPU_CONF``, ``./nnstreamer_tpu.ini``,
   ``~/.config/nnstreamer_tpu/nnstreamer_tpu.ini``,
   ``/etc/nnstreamer_tpu.ini``; read when the :class:`Conf` is made and
   again on :meth:`Conf.refresh`;
3. the defaults below.

Env vars are read at each lookup, so a knob set after import still counts.

Only the knobs that ported modules read are here, each with the JAX
package's default but one: ``[filter] torch_device`` defaults to ``cuda``
(the JAX package's is ``cpu``), since the port's entry points run on the
card unless asked for the CPU (``NNSTPU_FILTER_TORCH_DEVICE=cpu``).  The
JAX package's ``[segment] pallas_nms`` is not ported: fused segments here
always call the NMS kernel's wrapper, which runs the plain version on CPU
tensors.  Nor is ``[common] xplane_trace_dir`` (a device trace of the whole
PLAYING interval), which waits for the port's ``obs/profiler.py``.

External plugins are ``nnstpu_*.py`` files in the plugin dirs
(``$NNSTPU_PLUGIN_PATH``, then ``[common] plugin_path``; ``:``-separated).
They are imported on the first registry miss (:func:`lookup_with_plugin_fallback`)
and register themselves with ``register_element``, ``register_backend`` or
``register_decoder`` of this package.  They are imported as modules
``nns_torch_plugins.<file>``, a prefix of the port's own, so that the
JAX package and the port in one process never share a plugin module.  A
plugin written for the JAX package imports that package and fails here:
its import error surfaces, nothing skips the file.
"""

from __future__ import annotations

import configparser
import importlib.util
import os
import sys
import threading
from typing import Dict, List, Optional

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}

PLUGIN_PREFIX = "nns_torch_plugins."

DEFAULTS: Dict[str, Dict[str, str]] = {
    "common": {
        "plugin_path": "",          # colon-separated dirs of nnstpu_*.py
        "enable_profiling": "false",  # time each filter's invoke (Pipeline.stats)
        "dump_dot_dir": "",         # write <pipeline>.<STATE>.dot here
        "tracers": "",              # GST_TRACERS analog: "latency;stats;drops"
        "metrics_port": "",         # Prometheus scrape port ("" = disabled)
    },
    "filter": {
        "torch_device": "cuda",     # where models from files live
    },
    "fleet": {
        "repo_addr": "",            # a remote tensor repo: not ported, refused
    },
    # Observability (nnstreamer_tpu_torch/obs).  The short env spellings
    # NNSTPU_METRICS_BUCKETS / NNSTPU_FLIGHT_RECORDS take precedence over
    # the NNSTPU_OBS_* forms mapped here.
    "obs": {
        "buckets": "",              # latency-histogram bounds, ms ("0.1,1,10")
        "flight_records": "",       # span flight-recorder ring size per thread
        "flight_dump_dir": "",      # write {pipeline}.error.trace.json here
    },
    # The shared host buffer pool (pool.py).
    "pool": {
        "enabled": "true",          # false: every lease allocates afresh
        "max_per_class": "4",       # free buffers kept per (shape, dtype)
        "max_bytes": "67108864",    # free-list bytes in all (64 MiB)
    },
    # The warmup phase (graph/warmup.py).
    "compile": {
        "warmup": "false",          # capture every planned geometry before PLAYING
        "warmup_timeout_s": "600",  # the whole phase's deadline (0: none)
    },
    "segment": {
        "enabled": "false",         # plan and fold segments in Pipeline.start (a
                                    # pipeline's segment_compile attr overrides it)
    },
}

# Env spellings outside NNSTPU_<SECTION>_<KEY>: an alias of a knob, or the
# ini locator (None).
SHORT_ENV: Dict[str, Optional[tuple]] = {
    "NNSTPU_CONF": None,
    "NNSTPU_PLUGIN_PATH": ("common", "plugin_path"),
    "NNSTPU_TRACERS": ("common", "tracers"),
    "NNSTPU_METRICS_PORT": ("common", "metrics_port"),
    "NNSTPU_METRICS_BUCKETS": ("obs", "buckets"),
    "NNSTPU_FLIGHT_RECORDS": ("obs", "flight_records"),
}


class Conf:
    """Layered configuration (env > ini file > defaults) with lazy
    external-plugin loading."""

    def __init__(self, ini_path: Optional[str] = None, environ=None):
        self._lock = threading.Lock()
        self._environ = environ if environ is not None else os.environ
        self._explicit_ini = ini_path
        self._loaded_plugin_files: Dict[str, object] = {}
        self.refresh()

    def _ini_candidates(self) -> List[str]:
        cands = [self._explicit_ini, self._environ.get("NNSTPU_CONF"),
                 os.path.join(os.getcwd(), "nnstreamer_tpu.ini"),
                 os.path.expanduser("~/.config/nnstreamer_tpu/nnstreamer_tpu.ini"),
                 "/etc/nnstreamer_tpu.ini"]
        return [c for c in cands if c]

    def refresh(self) -> None:
        """Re-read the ini file (env vars are always read live)."""
        parser = configparser.ConfigParser()
        path = next((c for c in self._ini_candidates() if os.path.isfile(c)), None)
        if path:
            parser.read(path)
        with self._lock:
            self.ini_path = path
            self._ini = parser

    # -- typed getters (env > ini > defaults) --------------------------------

    def get(self, section: str, key: str, default: Optional[str] = None) -> Optional[str]:
        val = self._environ.get(f"NNSTPU_{section.upper()}_{key.upper()}")
        if val is not None:
            return val
        with self._lock:
            if self._ini.has_option(section, key):
                return self._ini.get(section, key)
        val = DEFAULTS.get(section, {}).get(key)
        return val if val is not None else default

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        val = self.get(section, key)
        if val is None or val == "":
            return default
        low = val.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"[{section}] {key}: not a boolean: {val!r}")

    def get_int(self, section: str, key: str, default: int = 0) -> int:
        val = self.get(section, key)
        return int(val) if val not in (None, "") else default

    def get_float(self, section: str, key: str, default: float = 0.0) -> float:
        val = self.get(section, key)
        return float(val) if val not in (None, "") else default

    def get_path(self, section: str, key: str, default: str = "") -> str:
        val = self.get(section, key, default)
        return os.path.expanduser(val) if val else val

    # -- external plugins ----------------------------------------------------

    def plugin_dirs(self) -> List[str]:
        """Plugin dirs: ``$NNSTPU_PLUGIN_PATH`` then ``[common] plugin_path``."""
        dirs: List[str] = []
        for source in (self._environ.get("NNSTPU_PLUGIN_PATH", ""),
                       self.get("common", "plugin_path", "") or ""):
            for d in source.split(os.pathsep):
                d = os.path.expanduser(d.strip())
                if d and d not in dirs:
                    dirs.append(d)
        return dirs

    def scan_plugin_files(self) -> List[str]:
        """All ``nnstpu_*.py`` files in the plugin dirs, sorted per dir."""
        files = []
        for d in self.plugin_dirs():
            if os.path.isdir(d):
                files += [os.path.join(d, f) for f in sorted(os.listdir(d))
                          if f.startswith("nnstpu_") and f.endswith(".py")]
        return files

    def load_external_plugins(self) -> int:
        """Import every plugin file not imported yet; returns how many.
        An import that fails raises, and the file is tried again next time."""
        loaded = 0
        for path in self.scan_plugin_files():
            real = os.path.realpath(path)
            with self._lock:
                if real in self._loaded_plugin_files:
                    continue
                # reserved before the import: a lookup from inside it cannot
                # import the file twice
                self._loaded_plugin_files[real] = None
            modname = PLUGIN_PREFIX + os.path.splitext(os.path.basename(path))[0]
            spec = importlib.util.spec_from_file_location(modname, real)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[modname] = mod
            try:
                spec.loader.exec_module(mod)
            except BaseException:
                with self._lock:
                    del self._loaded_plugin_files[real]
                sys.modules.pop(modname, None)
                raise
            with self._lock:
                self._loaded_plugin_files[real] = mod
            loaded += 1
        return loaded


conf = Conf()


def load_external_plugins() -> int:
    return conf.load_external_plugins()


def lookup_with_plugin_fallback(get):
    """A registry's miss: load the plugins not loaded yet and, if any
    loaded, ``get()`` again; else None."""
    if conf.load_external_plugins():
        return get()
    return None

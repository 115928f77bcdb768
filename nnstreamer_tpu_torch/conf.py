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
package's default (``[recovery] cpu_fallback`` is left out: the port never
serves a frame from the CPU after a capture fails) but one: ``[filter] torch_device`` defaults to ``cuda``
(the JAX package's is ``cpu``), since the port's entry points run on the
card unless asked for the CPU (``NNSTPU_FILTER_TORCH_DEVICE=cpu``).  The
JAX package's ``[segment] pallas_nms`` is not ported: fused segments here
always call the NMS kernel's wrapper, which runs the plain version on CPU
tensors.  ``[common] xplane_trace_dir`` keeps the JAX package's name; the
port writes a ``torch.profiler`` (Kineto JSON) trace there.

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
        "native_runtime": "true",   # C++ frame queue (native/); off: the Python twin
        "dump_dot_dir": "",         # write <pipeline>.<STATE>.dot here
        "tracers": "",              # GST_TRACERS analog: "latency;stats;drops"
        "metrics_port": "",         # Prometheus scrape port ("" = disabled)
        "xplane_trace_dir": "",     # torch.profiler trace of PLAYING (Kineto JSON)
    },
    "filter": {
        "torch_device": "cuda",     # where models from files live
    },
    # The fleet tier (fleet/): the NNSQ router and worker membership.
    # NNSTPU_FLEET_* env vars map here.
    "fleet": {
        "heartbeat_s": "0.5",       # membership probe interval
        "probe_timeout_s": "2.0",   # per-probe deadline
        "suspect_misses": "2",      # missed probes before SUSPECT (no new
                                    # dispatch; in-flight work completes)
        "death_misses": "6",        # missed probes before DOWN (ejected)
        "breaker_failures": "3",    # data-path failures to quarantine a
                                    # flapping worker (per-worker breaker)
        "breaker_reset_s": "2.0",   # quarantine -> half-open probe delay
        "route_retries": "3",       # extra workers tried per request
        "retry_backoff_ms": "20",   # first re-route backoff (doubles)
        "retry_backoff_cap_ms": "500",
        "connect_timeout_s": "5",   # router -> worker dial deadline
        "request_timeout_s": "30",  # router -> worker reply deadline
        "drain_deadline_s": "10",   # session-drain wait before force-break
        "repo_addr": "",            # host:port of a TensorRepoServer (fleet/repo.py)
        "migrate": "1",             # live-migrate decode sessions on a
                                    # planned drain (needs repo_addr);
                                    # 0 = force-break with [SESSION]
        "migrate_timeout_s": "10",  # per-handoff deadline (quiesce +
                                    # snapshot + restore + re-pin)
        "migrate_check_s": "0.25",  # stateful router's monitor period
                                    # for self-draining workers
    },
    # The elastic fleet (fleet/autoscaler.py, fleet/supervisor.py): the
    # SLO-driven control loop.  NNSTPU_AUTOSCALE_* env vars map here.
    "autoscale": {
        "min_workers": "1",         # fleet floor (never drained below)
        "max_workers": "4",         # fleet ceiling (never spawned above)
        "interval_s": "0.5",        # control-loop tick period
        "queue_wait_hi_ms": "50",   # queue-wait p99 above this => scale up
        "queue_wait_lo_ms": "5",    # ...below this (and idle) => scale down
        "busy_hi": "0.85",          # device busy fraction upper band
        "busy_lo": "0.20",          # ...lower band (scale-down eligible)
        "shed_hi": "0.01",          # shed rate (shed/offered) => scale up
        "up_cooldown_s": "1",       # least gap between scale-up actions
        "down_cooldown_s": "5",     # least gap between scale-down actions
        "flap_window_s": "30",      # direction reversals counted here...
        "flap_limit": "3",          # ...beyond this: damped (held steady)
        "storm_budget": "6",        # spawns per storm window before the
                                    # typed degraded /healthz escalation
        "storm_window_s": "30",     # the spawn-storm budget window
        "forecast": "true",         # predictive leg over the offered-load
                                    # history
        "forecast_horizon_s": "5",  # how far ahead the forecast looks
        "history_window_s": "60",   # offered-load history retained
        "worker_rps": "0",          # per-worker capacity estimate feeding
                                    # the forecast (0 = predictive leg off)
        "crash_limit": "3",         # worker deaths within crash_window_s
                                    # => crash-loop quarantine
        "crash_window_s": "30",     # the crash-loop detection window
        "quarantine_s": "30",       # hold-down before a quarantined
                                    # worker may respawn
        "respawn_backoff_ms": "200",   # first respawn backoff (doubles)
        "respawn_backoff_cap_ms": "5000",  # respawn backoff ceiling
        "spawn_timeout_s": "30",    # spawn + warmup deadline before the
                                    # attempt counts as failed
    },
    # The SLO burn-rate engine (obs/slo.py): latency objectives evaluated
    # at scrape time over registry histogram windows, served on /alerts
    # and the `alert` hook.  NNSTPU_SLO_* env vars map here.
    "slo": {
        # "name:metric{label=value,...}<bound_ms@target", semicolon-
        # separated; metric defaults to nnstpu_e2e_latency_ms, e.g.
        # "e2e:<50ms@0.999;tenantA:{tenant=A}<25ms@0.99"
        "objectives": "",
        "fast_window_s": "60",      # fast burn window (paging signal)
        "slow_window_s": "600",     # slow burn window (confirmation)
        "fast_burn": "14.0",        # firing threshold on the fast window
        "slow_burn": "6.0",         # firing threshold on the slow window
        "eval_interval_s": "5",     # least seconds between evaluations
    },
    # Serving QoS (sched/): NNSTPU_SCHED_* env vars map here.  An empty
    # policy disables scheduling entirely (plain FIFO dispatch).
    "sched": {
        "policy": "",               # fifo | prio | edf | drr
        "max_queue_per_client": "64",
        "rate": "0",                # admitted requests/s per tenant (0 = off)
        "burst": "0",               # token-bucket depth (0 = max(1, rate))
        "deadline_ms": "0",         # queued-request deadline (0 = none)
        "breaker_failures": "0",    # consecutive failures to trip (0 = off)
        "breaker_reset_s": "30",    # open -> half-open probe delay
        "quantum": "8",             # DRR per-round credit (cost units)
        "priorities": "",           # "clientA=10,clientB=2" strict/slot prio
        "max_waiting": "16",        # bounded slot-waiter room (DecodeServer)
    },
    # Observability (nnstreamer_tpu_torch/obs).  The short env spellings
    # NNSTPU_METRICS_BUCKETS / NNSTPU_FLIGHT_RECORDS take precedence over
    # the NNSTPU_OBS_* forms mapped here.
    "obs": {
        "buckets": "",              # latency-histogram bounds, ms ("0.1,1,10")
        "flight_records": "",       # span flight-recorder ring size per thread
        "flight_dump_dir": "",      # write {pipeline}.error.trace.json here
        # The device lane (obs/device.py): the bound of the completion-probe
        # queue of the DeviceTracer's reaper thread (overflow drops probes,
        # counted).
        "device_probe_queue": "1024",
        # The utilization lane (obs/util.py): MFU and roofline peaks ("" =
        # the card's published default by its name, e.g. the H100 SXM's
        # 989 TFLOP/s bf16 and 3350 GB/s), the sliding window behind
        # nnstpu_device_busy_fraction, and the shortest device idle gap
        # that becomes a device_idle flight span.
        "peak_tflops": "",
        "peak_gbs": "",
        "busy_window_s": "10",
        "device_idle_gap_ms": "5",
        # The pipeline health watchdog (obs/watchdog.py, tracer "watchdog").
        "watchdog_interval": "1.0",         # monitor tick, seconds
        "watchdog_stall_s": "5.0",          # source and queue stall window
        "watchdog_queue_depth": "1",        # least depth of a wedged queue
        "watchdog_device_deadline_s": "30", # device completion deadline
        "watchdog_recover": "false",        # escalate a verdict to recovery
        "watchdog_recover_budget": "3",     # recovery attempts per target
        # >0: the watchdog probes the host-to-device wire every this many
        # seconds and publishes the nnstpu_wire_* gauges (obs/util.py)
        "watchdog_wire_probe_s": "0",
        # The cost observatory (obs/costmodel.py, tracer "costmodel"): the
        # persisted per-stage cost model, its EWMA smoothing factor, and
        # whether the tracer's stop() flushes it to disk.
        "costmodel_path": "COST_MODEL.json",
        "costmodel_alpha": "0.2",
        "costmodel_autosave": "true",
        # Tail forensics (obs/forensics.py, tracer "forensics"): traces
        # whose leg decomposition leaves the cost-model noise band count
        # as outliers and, with a directory set, are captured as flight
        # dumps (slowest K kept under a byte cap).
        "forensics_dir": "",            # "" = score and count, never capture
        "forensics_keep": "8",          # gallery entries kept (slowest K)
        "forensics_max_bytes": "16777216",  # gallery byte cap (16 MiB)
        "forensics_sigmas": "3.0",      # noise-band sigmas (leg_band_us)
        "forensics_min_rel": "0.10",    # noise-band relative floor
        "forensics_min_abs_us": "5.0",  # noise-band absolute floor, us
        "forensics_min_samples": "32",  # live-baseline warm-up before verdicts
        # The deep-profiling lane (obs/profiler.py): torch.profiler capture
        # windows, per-op attribution and the captured graphs' memory
        # ledger.  The gallery holds the newest profile_keep captures under
        # profile_max_bytes; the watchdog's trigger (profile_auto) starts a
        # profile_auto_seconds window, at most once per
        # profile_auto_cooldown_s, when a dispatch's device time leaves the
        # profile_sigmas/profile_min_rel/profile_min_abs_us noise band after
        # profile_min_samples.
        "profile_dir": "",              # capture gallery ("" = process temp)
        "profile_keep": "4",            # gallery entries retained (newest K)
        "profile_max_bytes": "67108864",  # gallery byte cap (64 MiB)
        "profile_default_seconds": "2.0",  # window when none requested
        "profile_top_k": "20",          # op rows kept in the summary table
        "profile_auto": "false",        # watchdog-triggered capture
        "profile_auto_seconds": "1.0",  # its window
        "profile_auto_cooldown_s": "120",  # least seconds between two
        "profile_sigmas": "3.0",        # degrade noise-band sigmas
        "profile_min_rel": "0.10",      # degrade noise-band relative floor
        "profile_min_abs_us": "50.0",   # degrade noise-band absolute floor, us
        "profile_min_samples": "32",    # per-capture samples before verdicts
    },
    # The chaos engine (faults/): seeded fault injection.  The short env
    # spelling NNSTPU_FAULTS takes precedence over NNSTPU_FAULTS_SPEC.
    "faults": {
        "spec": "",                 # e.g. "seed=42;invoke_raise@f:every=5"
        "seed": "0",                # default seed (a seed= clause wins)
    },
    # Self-healing (graph/pipeline.py restart policies).  There is no
    # [recovery] cpu_fallback: a capture that fails is never served from
    # the CPU.
    "recovery": {
        "policy": "",               # default per-node policy: restart |
                                    # quarantine-passthrough | fail-pipeline
                                    # ("" = fail-pipeline)
        "max_restarts": "5",        # restart-storm budget per node ...
        "window_s": "30",           # ... within this sliding window
        "backoff_ms": "50",         # first restart backoff (doubles)
        "backoff_cap_ms": "2000",   # backoff ceiling
    },
    # The shared host buffer pool (pool.py).
    "pool": {
        "enabled": "true",          # false: every lease allocates afresh
        "max_per_class": "4",       # free buffers kept per (shape, dtype)
        "max_bytes": "67108864",    # free-list bytes in all (64 MiB)
    },
    # The warmup phase (graph/warmup.py) and the kernel autotune cache
    # (ops/autotune.py).  NNSTPU_COMPILE_* env vars map here.
    "compile": {
        "cache_dir": "",            # root of the persistent autotune cache
                                    # ("" = no cache: the kernels' static geometry)
        "warmup": "false",          # capture every planned geometry before PLAYING
        "warmup_timeout_s": "600",  # the whole phase's deadline (0: none)
        "autotune": "true",         # consult the autotune cache for kernel geometry
    },
    # The dispatcher lanes (graph/lanes.py): run-to-completion lane tasks
    # in place of a thread an element.  NNSTPU_DISPATCH_* env vars map here
    # (NNSTPU_DISPATCH_LANES is the documented spelling).
    "dispatch": {
        "lanes": "0",               # 0 = a thread an element; "auto" =
                                    # min(4, cpus); N pins the lane count
        "helpers": "16",            # the bounded helper pool of blocking tasks
        "block_ms": "20",           # a source pull over this counts as blocking
        "quantum": "8",             # items a task slice before the lane yields
    },
    "segment": {
        "enabled": "false",         # plan and fold segments in Pipeline.start (a
                                    # pipeline's segment_compile attr overrides it)
    },
    # The dispatch mesh (parallel/mesh.py dispatch_mesh): batch-sharded
    # dispatch over the devices.  The short spelling NNSTPU_MESH wins over
    # the NNSTPU_MESH_SPEC form mapped here.
    "mesh": {
        "spec": "",                 # "" = off; "auto" | "dp:4" | "4": see
                                    # parallel.mesh.parse_mesh_spec
    },
    # Among-device partitioning (partition/): the cost-model-driven
    # planner, its deployment and the repartition monitor.
    # NNSTPU_PARTITION_* env vars map here.
    "partition": {
        "edge": "edge0",            # default partition-edge label (tags
                                    # nnsq_rtt spans -> hop:{edge} leg)
        "monitor_interval_s": "1.0",   # repartition monitor tick period
        "noise_multiplier": "3.0",  # stage-cost drift beyond
                                    # leg_std_us * this triggers a replan
        "default_cut_bytes": "150528",  # transfer bytes a frame at a cut
                                    # whose stage has no copy_bytes_per_frame
        "probe_n": "4",             # round trips an edge health probe
        "warm_timeout_s": "30",     # deploy: wait for the server fragment
                                    # worker to report "ok"
    },
    # The analysis instruments (analysis/): runtime lockdep.  The short
    # spelling NNSTPU_LOCKDEP wins over NNSTPU_ANALYSIS_LOCKDEP.
    "analysis": {
        "lockdep": "false",         # wrap threading.Lock/RLock/Condition
                                    # with the lock-order verifier
        "lockdep_block_ms": "200",  # blocked-while-holding report threshold
        "lockdep_allow": "",        # comma-separated site substrings whose
                                    # findings are accepted (annotated)
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
    "NNSTPU_PEAK_TFLOPS": ("obs", "peak_tflops"),
    "NNSTPU_PEAK_GBS": ("obs", "peak_gbs"),
    "NNSTPU_MESH": ("mesh", "spec"),
    "NNSTPU_FAULTS": ("faults", "spec"),
    "NNSTPU_LOCKDEP": ("analysis", "lockdep"),
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

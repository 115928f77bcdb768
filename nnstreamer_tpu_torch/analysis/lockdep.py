"""Runtime lockdep: lock-order verification for the threaded runtime.

The port's copy of the JAX package's ``analysis/lockdep.py``: the same
proxies, order graph, findings and report, with its findings also written
as instants into the port's flight recorder (``obs/flight.py``, through
:func:`~nnstreamer_tpu_torch.obs.spans.record_instant`).

The Linux-kernel lockdep idea in CPython terms.  The runtime holds many
lock and condition sites and daemon threads (pipeline workers, the device
reaper, the watchdog, the NNSQ router, the membership prober, the
migration handoff, the launch gate) and nothing verifies their ordering.
This module makes a run a deadlock detector:

- :func:`install` swaps ``threading.Lock``/``RLock``/``Condition`` for
  factories that return **tracking proxies**.  Each proxy is keyed by
  its *allocation site* (``file.py:lineno`` of the first in-scope frame),
  so all locks born at one code site share one node in the order graph —
  per-instance locks (one per session, per node, per worker) collapse to
  the class of lock they are, which is what an ordering discipline is
  about.
- every thread keeps a held-lock stack; acquiring ``B`` while holding
  ``A`` adds the edge ``A → B`` to a global acquisition-order graph with
  a witness (thread + acquire stack).  A **cycle** in that graph is a
  potential ABBA deadlock even if the interleaving never fired in this
  run — that is the whole point.
- a blocking acquire that *waits* longer than ``[analysis]
  lockdep_block_ms`` while the thread already holds locks is reported as
  a contention outlier (``blocked_while_holding``).
- blocking calls made **under a lock** are reported
  (``blocking_call_under_lock``): ``socket.recv``/``recv_into``/
  ``accept`` on a timeout-less socket, ``queue.Queue.get`` with no
  timeout, ``subprocess.Popen.wait`` with no timeout.

Findings surface as a process-exit report on stderr (``atexit``), through
:func:`report` / :func:`format_report` (the soak campaign's ``--lockdep``
verdict), and as flight-recorder instants (``lockdep:<kind>``), so a cycle
shows up in the Perfetto timeline next to the dispatch spans that made it.

Activation — opt-in only, zero impact when off:

- ``NNSTPU_LOCKDEP=1`` (short spelling) or ini ``[analysis] lockdep``
  via :func:`maybe_install`, called from ``nnstreamer_tpu_torch/__init__``;
- :func:`install` / :func:`uninstall` directly (tests).

Scope: only locks *allocated from* in-scope code (anything outside the
stdlib and site-packages — i.e. this repo and its tests) are tracked;
third-party and interpreter-internal locks pass through untouched, so
PyTorch's internals do not drown the report.

Annotating accepted findings: :func:`allow` (or ini ``[analysis]
lockdep_allow`` — comma-separated substrings) suppresses findings whose
sites match; use it for ordering the code *proves* safe by other means,
and say why at the allow() call site.
"""

from __future__ import annotations

import atexit
import os
import queue as _queue_mod
import socket as _socket_mod
import subprocess as _subprocess_mod
import sys
import sysconfig
import threading
import time
import traceback
import _thread
from typing import Dict, List, Optional, Tuple

__all__ = [
    "install", "uninstall", "installed", "maybe_install", "reset",
    "allow", "report", "format_report", "findings",
]

# ---------------------------------------------------------------------------
# state (all guarded by _glock, a raw untracked lock)

_glock = _thread.allocate_lock()
_installed = False
_orig: Dict[str, object] = {}

_tls = threading.local()

# acquisition-order graph: (site_a, site_b) -> witness dict
_edges: Dict[Tuple[str, str], dict] = {}
_adj: Dict[str, set] = {}           # site -> set of successor sites
_sites: set = set()                  # every tracked allocation site
_findings: List[dict] = []           # deduped findings, append-only
_fingerprints: set = set()
_suppressed = 0
_allow_patterns: List[str] = []
_block_ms = 200.0

_STDLIB = os.path.realpath(sysconfig.get_paths()["stdlib"])
_SKIP_FILES = {
    os.path.realpath(__file__),
    os.path.realpath(threading.__file__),
    os.path.realpath(_queue_mod.__file__),
    os.path.realpath(_socket_mod.__file__),
    os.path.realpath(_subprocess_mod.__file__),
}


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _in_scope(filename: str) -> bool:
    if filename in ("<stdin>", "<string>"):
        return True  # scripts run with -c or from standard input
    if not filename or filename.startswith("<"):
        return False
    real = os.path.realpath(filename)
    if real.startswith(_STDLIB):
        return False
    return "site-packages" not in real and "dist-packages" not in real


def _caller_site() -> Optional[str]:
    """``file.py:lineno`` of the nearest frame outside this module and the
    wrapped stdlib modules; None when that frame is out of scope."""
    f = sys._getframe(1)
    while f is not None and os.path.realpath(f.f_code.co_filename) in _SKIP_FILES:
        f = f.f_back
    if f is None or not _in_scope(f.f_code.co_filename):
        return None
    path = f.f_code.co_filename.replace(os.sep, "/")
    short = "/".join(path.split("/")[-2:])
    return f"{short}:{f.f_lineno}"


def _short_stack(limit: int = 6) -> List[str]:
    out = []
    for fr in traceback.extract_stack(limit=limit + 4)[:-2]:
        if os.path.realpath(fr.filename) in _SKIP_FILES:
            continue
        path = "/".join(fr.filename.replace(os.sep, "/").split("/")[-2:])
        out.append(f"{path}:{fr.lineno} in {fr.name}")
    return out[-limit:]


def _suppressed_by_allow(sites) -> bool:
    for pat in _allow_patterns:
        for s in sites:
            if pat and pat in s:
                return True
    return False


def _add_finding(kind: str, fingerprint: tuple, sites, detail: dict) -> None:
    global _suppressed
    with _glock:
        if fingerprint in _fingerprints:
            return
        _fingerprints.add(fingerprint)
        if _suppressed_by_allow(sites):
            _suppressed += 1
            return
        finding = {"kind": kind, "sites": list(sites),
                   "thread": threading.current_thread().name, **detail}
        _findings.append(finding)
    # surface in the flight recorder so a cycle lands on the Perfetto
    # timeline next to the spans that created it
    try:
        from ..obs import spans
        if spans.enabled:  # the flight recorder (obs/flight.py) is on
            spans.record_instant(f"lockdep:{kind}", cat="lockdep",
                                 args={"sites": ",".join(sites)})
    except Exception:  # noqa: BLE001 — the detector must never take the run down
        pass


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst in the order graph (caller holds _glock)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _adj.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquired(site: str, entry: list, wait_ns: int) -> None:
    """Post-acquire bookkeeping: order edges, cycle check, contention."""
    stack = _held()
    held_sites = []
    for e in stack:
        if e[1] not in held_sites and e[1] != site:
            held_sites.append(e[1])
    stack.append(entry)
    new_edges = []
    if held_sites:
        with _glock:
            for h in held_sites:
                if (h, site) not in _edges:
                    _edges[(h, site)] = {
                        "thread": threading.current_thread().name,
                        "stack": _short_stack(),
                        "count": 1,
                    }
                    _adj.setdefault(h, set()).add(site)
                    new_edges.append(h)
                else:
                    _edges[(h, site)]["count"] += 1
    for h in new_edges:
        # a new edge h -> site closes a cycle iff site already reaches h
        with _glock:
            back = _find_path(site, h)
        if back:
            cycle = back  # site -> ... -> h; edge h -> site closes it
            fp = ("cycle", tuple(sorted(set(cycle))))
            with _glock:
                witnesses = {
                    f"{a} -> {b}": _edges[(a, b)]["thread"]
                    for a, b in zip(cycle, cycle[1:] + cycle[:1])
                    if (a, b) in _edges
                }
            _add_finding(
                "order_cycle", fp, sorted(set(cycle)),
                {"cycle": " -> ".join(cycle + [cycle[0]]),
                 "witnesses": witnesses},
            )
    if wait_ns > _block_ms * 1e6 and held_sites:
        _add_finding(
            "blocked_while_holding",
            ("blocked", site, tuple(held_sites)),
            [site] + held_sites,
            {"waited_ms": round(wait_ns / 1e6, 1), "holding": held_sites,
             "stack": _short_stack()},
        )


def _note_released(entry: list) -> None:
    stack = entry[0]
    try:
        # non-LIFO and cross-thread releases are legal (mig_lock hands
        # off between the serve and migrate threads) — remove by identity
        # from the stack the entry was pushed on, wherever we are
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is entry:
                del stack[i]
                return
    except Exception:  # noqa: BLE001
        pass


# ---------------------------------------------------------------------------
# proxies

class _LockProxy:
    """Tracking wrapper around a raw ``_thread.lock``."""

    __slots__ = ("_inner", "_site", "_entry")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site
        self._entry = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(False)
        wait_ns = 0
        if not got:
            if not blocking:
                return False
            t0 = time.monotonic_ns()
            got = self._inner.acquire(True, timeout)
            wait_ns = time.monotonic_ns() - t0
            if not got:
                return False
        entry = [_held(), self._site, time.monotonic_ns()]
        self._entry = entry
        _note_acquired(self._site, entry, wait_ns)
        return True

    def release(self) -> None:
        entry, self._entry = self._entry, None
        self._inner.release()
        if entry is not None:
            _note_released(entry)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def _at_fork_reinit(self):
        self._inner._at_fork_reinit()
        self._entry = None

    def __repr__(self):
        return f"<lockdep.Lock site={self._site} {self._inner!r}>"


class _RLockProxy:
    """Tracking wrapper around a real RLock (push on first acquire, pop
    on last release; exposes the ``_release_save`` protocol so it can
    back a ``threading.Condition``)."""

    __slots__ = ("_inner", "_site", "_count", "_owner", "_entry")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site
        self._count = 0
        self._owner = None
        self._entry = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = _thread.get_ident()
        if self._owner == me:
            if not self._inner.acquire(blocking, timeout):
                return False
            self._count += 1
            return True
        got = self._inner.acquire(False)
        wait_ns = 0
        if not got:
            if not blocking:
                return False
            t0 = time.monotonic_ns()
            got = self._inner.acquire(True, timeout)
            wait_ns = time.monotonic_ns() - t0
            if not got:
                return False
        self._owner = me
        self._count = 1
        entry = [_held(), self._site, time.monotonic_ns()]
        self._entry = entry
        _note_acquired(self._site, entry, wait_ns)
        return True

    __enter__ = acquire

    def release(self) -> None:
        self._inner.release()
        self._count -= 1
        if self._count <= 0:
            self._owner = None
            entry, self._entry = self._entry, None
            if entry is not None:
                _note_released(entry)

    def __exit__(self, *exc):
        self.release()

    # -- the Condition backing protocol ------------------------------------
    def _release_save(self):
        state = self._inner._release_save()
        count, self._count = self._count, 0
        self._owner = None
        entry, self._entry = self._entry, None
        if entry is not None:
            _note_released(entry)
        return (state, count)

    def _acquire_restore(self, saved):
        state, count = saved
        self._inner._acquire_restore(state)
        self._owner = _thread.get_ident()
        self._count = count
        entry = [_held(), self._site, time.monotonic_ns()]
        self._entry = entry
        _note_acquired(self._site, entry, 0)

    def _is_owned(self) -> bool:
        return self._owner == _thread.get_ident()

    def _at_fork_reinit(self):
        self._inner._at_fork_reinit()
        self._count = 0
        self._owner = None
        self._entry = None

    def __repr__(self):
        return f"<lockdep.RLock site={self._site} {self._inner!r}>"


# ---------------------------------------------------------------------------
# factories + blocking-call wrappers

def _make_lock():
    site = _caller_site()
    inner = _orig["Lock"]()
    if site is None:
        return inner
    with _glock:
        _sites.add(site)
    return _LockProxy(inner, site)


def _make_rlock():
    site = _caller_site()
    inner = _orig["RLock"]()
    if site is None:
        return inner
    with _glock:
        _sites.add(site)
    return _RLockProxy(inner, site)


def _make_condition(lock=None):
    if lock is None:
        lock = _make_rlock()
    return _orig["Condition"](lock)


def _flag_blocking_call(what: str) -> None:
    if not getattr(_tls, "stack", None):
        return
    site = _caller_site()
    if site is None:
        return  # out-of-scope caller (library internals)
    holding = []
    for e in _held():
        if e[1] not in holding:
            holding.append(e[1])
    _add_finding(
        "blocking_call_under_lock", ("blocking", what, site),
        [site] + holding,
        {"call": what, "holding": holding, "stack": _short_stack()},
    )


def _wrap_recv(self, *args, **kw):
    if self.gettimeout() is None:
        _flag_blocking_call("socket.recv")
    return _orig["socket.recv"](self, *args, **kw)


def _wrap_recv_into(self, *args, **kw):
    if self.gettimeout() is None:
        _flag_blocking_call("socket.recv_into")
    return _orig["socket.recv_into"](self, *args, **kw)


def _wrap_accept(self, *args, **kw):
    if self.gettimeout() is None:
        _flag_blocking_call("socket.accept")
    return _orig["socket.accept"](self, *args, **kw)


def _wrap_queue_get(self, block=True, timeout=None):
    if block and timeout is None:
        _flag_blocking_call("queue.get")
    return _orig["queue.get"](self, block, timeout)


def _wrap_popen_wait(self, timeout=None):
    if timeout is None:
        _flag_blocking_call("subprocess.wait")
    return _orig["popen.wait"](self, timeout)


# ---------------------------------------------------------------------------
# public API

def installed() -> bool:
    return _installed


def install(block_ms: Optional[float] = None,
            allow_patterns: Optional[List[str]] = None) -> bool:
    """Swap the threading constructors for tracking factories.  Locks
    created *before* install are untracked; install as early as possible
    (``maybe_install`` runs from ``nnstreamer_tpu_torch/__init__``).  Returns
    False when already installed."""
    global _installed, _block_ms
    with _glock:
        if _installed:
            return False
        _installed = True
    if block_ms is None:
        try:
            from ..conf import conf
            block_ms = conf.get_float("analysis", "lockdep_block_ms", 200.0)
            conf_allow = conf.get("analysis", "lockdep_allow", "") or ""
        except Exception:  # noqa: BLE001 — usable standalone in fixtures
            block_ms = 200.0
            conf_allow = ""
    else:
        conf_allow = ""
    _block_ms = float(block_ms)
    for pat in conf_allow.split(","):
        pat = pat.strip()
        if pat:
            _allow_patterns.append(pat)
    if allow_patterns:
        _allow_patterns.extend(allow_patterns)

    _orig["Lock"] = threading.Lock
    _orig["RLock"] = threading.RLock
    _orig["Condition"] = threading.Condition
    _orig["socket.recv"] = _socket_mod.socket.recv
    _orig["socket.recv_into"] = _socket_mod.socket.recv_into
    _orig["socket.accept"] = _socket_mod.socket.accept
    _orig["queue.get"] = _queue_mod.Queue.get
    _orig["popen.wait"] = _subprocess_mod.Popen.wait

    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition
    _socket_mod.socket.recv = _wrap_recv
    _socket_mod.socket.recv_into = _wrap_recv_into
    _socket_mod.socket.accept = _wrap_accept
    _queue_mod.Queue.get = _wrap_queue_get
    _subprocess_mod.Popen.wait = _wrap_popen_wait
    atexit.register(_exit_report)
    return True


def uninstall() -> None:
    """Restore the real constructors (already-created proxies keep
    working — they wrap real locks) and drop accumulated state."""
    global _installed
    with _glock:
        if not _installed:
            return
        _installed = False
    threading.Lock = _orig.pop("Lock")
    threading.RLock = _orig.pop("RLock")
    threading.Condition = _orig.pop("Condition")
    # socket.recv/recv_into are inherited from _socket.socket: deleting
    # the subclass attribute restores the C implementation
    del _socket_mod.socket.recv
    del _socket_mod.socket.recv_into
    _socket_mod.socket.accept = _orig.pop("socket.accept")
    _orig.pop("socket.recv")
    _orig.pop("socket.recv_into")
    _queue_mod.Queue.get = _orig.pop("queue.get")
    _subprocess_mod.Popen.wait = _orig.pop("popen.wait")
    atexit.unregister(_exit_report)
    del _allow_patterns[:]  # re-derived from conf on the next install
    reset()


_TRUE = {"1", "true", "yes", "on"}


def maybe_install() -> bool:
    """Env/conf-gated install: ``NNSTPU_LOCKDEP`` (short spelling) wins,
    else ini ``[analysis] lockdep``.  Cheap no-op when disabled."""
    env = os.environ.get("NNSTPU_LOCKDEP")
    if env is not None:
        if env.strip().lower() in _TRUE:
            return install()
        return False
    try:
        from ..conf import conf
        if conf.get_bool("analysis", "lockdep", False):
            return install()
    except Exception:  # noqa: BLE001 — conf must never block startup
        pass
    return False


def allow(*patterns: str) -> None:
    """Suppress findings whose sites contain any of ``patterns`` — the
    explicit annotation for orderings proven safe by other means."""
    with _glock:
        _allow_patterns.extend(p for p in patterns if p)


def reset() -> None:
    """Drop the order graph and findings (keeps the installation)."""
    global _suppressed
    with _glock:
        _edges.clear()
        _adj.clear()
        _sites.clear()
        _findings.clear()
        _fingerprints.clear()
        _suppressed = 0


def findings(kind: Optional[str] = None) -> List[dict]:
    with _glock:
        out = list(_findings)
    if kind:
        out = [f for f in out if f["kind"] == kind]
    return out


def report() -> dict:
    with _glock:
        return {
            "installed": _installed,
            "sites": len(_sites),
            "edges": len(_edges),
            "suppressed": _suppressed,
            "cycles": [f for f in _findings if f["kind"] == "order_cycle"],
            "blocked": [f for f in _findings
                        if f["kind"] == "blocked_while_holding"],
            "blocking_calls": [f for f in _findings
                               if f["kind"] == "blocking_call_under_lock"],
        }


def format_report() -> str:
    rep = report()
    lines = [
        f"lockdep: {rep['sites']} lock sites, {rep['edges']} order edges, "
        f"{len(rep['cycles'])} cycle(s), {len(rep['blocked'])} contention "
        f"outlier(s), {len(rep['blocking_calls'])} blocking call(s) under "
        f"lock, {rep['suppressed']} suppressed"
    ]
    for f in rep["cycles"]:
        lines.append(f"  CYCLE {f['cycle']}")
        for edge, thread in f.get("witnesses", {}).items():
            lines.append(f"    {edge}  [thread {thread}]")
    for f in rep["blocked"]:
        lines.append(
            f"  BLOCKED {f['sites'][0]} waited {f['waited_ms']} ms while "
            f"holding {', '.join(f['holding'])}  [thread {f['thread']}]")
    for f in rep["blocking_calls"]:
        lines.append(
            f"  BLOCKING-CALL {f['call']} at {f['sites'][0]} holding "
            f"{', '.join(f['holding'])}  [thread {f['thread']}]")
        for fr in f.get("stack", [])[-3:]:
            lines.append(f"    {fr}")
    return "\n".join(lines)


def _exit_report() -> None:
    rep = report()
    if rep["cycles"] or rep["blocked"] or rep["blocking_calls"]:
        print("\n" + format_report(), file=sys.stderr)

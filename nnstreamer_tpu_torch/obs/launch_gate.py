"""No CUDA graph launch while ``torch.profiler`` starts or stops.

``torch.profiler``'s stop (``_disable_profiler``, which holds the GIL
throughout) can hang for good while another thread launches a CUDA graph
(ROADMAP C17; ``tools/profiler_stop_probe.py`` shows it).  The port launches
graphs from pipeline threads while the deep-profiling lane opens and closes
its windows on others (``obs/profiler.py``: ``/profile``, the watchdog's
``profile_auto``), so the two are kept apart here:

- every graph replay of the port runs inside :func:`launching`, which
  waits while a profiler switches and counts the launch in flight;
- the profiler's start and stop run inside :func:`switching`, which holds
  new launches back, waits for those in flight, and lets them go once the
  profiler's state has changed.

A launch pays two uncontended lock round trips; the pipeline waits for a
switch as long as the stop takes, which held the GIL all along anyway.
"""

from __future__ import annotations

import contextlib
import threading

_cv = threading.Condition()
_in_flight = 0
_switching = False


@contextlib.contextmanager
def launching():
    """Around one graph launch: waits while the profiler switches."""
    global _in_flight
    with _cv:
        while _switching:
            _cv.wait()
        _in_flight += 1
    try:
        yield
    finally:
        with _cv:
            _in_flight -= 1
            if not _in_flight:
                _cv.notify_all()


@contextlib.contextmanager
def switching():
    """Around a profiler's start or stop: no graph launch meanwhile.  One
    switch at a time; a switch inside a launch of the same thread would
    wait for itself, and none of the port's does."""
    global _switching
    with _cv:
        while _switching:
            _cv.wait()
        _switching = True
        while _in_flight:
            _cv.wait()
    try:
        yield
    finally:
        with _cv:
            _switching = False
            _cv.notify_all()

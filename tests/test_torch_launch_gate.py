"""The launch gate: no graph launch while the profiler starts or stops."""

import threading
import time

import pytest

from nnstreamer_tpu_torch.obs import launch_gate, profiler


def _in_thread(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def test_a_switch_waits_for_the_launches_in_flight():
    order = []
    entered = threading.Event()
    release = threading.Event()

    def launch():
        with launch_gate.launching():
            entered.set()
            release.wait(5)
            order.append("launch done")

    def switch():
        with launch_gate.switching():
            order.append("switched")

    t1 = _in_thread(launch)
    assert entered.wait(5)
    t2 = _in_thread(switch)
    time.sleep(0.05)
    assert order == []  # the switch waits for the launch
    release.set()
    t1.join(5)
    t2.join(5)
    assert order == ["launch done", "switched"]


def test_launches_wait_while_the_profiler_switches():
    order = []
    inside = threading.Event()
    release = threading.Event()

    def switch():
        with launch_gate.switching():
            inside.set()
            release.wait(5)
            order.append("switched")

    def launch():
        with launch_gate.launching():
            order.append("launched")

    t1 = _in_thread(switch)
    assert inside.wait(5)
    t2 = _in_thread(launch)
    time.sleep(0.05)
    assert order == []  # the launch is held back
    release.set()
    t1.join(5)
    t2.join(5)
    assert order == ["switched", "launched"]


def test_the_gate_opens_again_after_an_error():
    for ctx in (launch_gate.switching, launch_gate.launching):
        with pytest.raises(RuntimeError):
            with ctx():
                raise RuntimeError("failed")
    done = []

    def both():
        with launch_gate.switching():
            pass
        with launch_gate.launching():
            done.append(1)

    _in_thread(both).join(5)
    assert done == [1]


@pytest.mark.parametrize("step", ["start", "stop"])
def test_the_profiler_switches_inside_the_gate(monkeypatch, step):
    seen = []

    class Prof:
        def start(self):
            seen.append(("start", launch_gate._switching))

        def stop(self):
            seen.append(("stop", launch_gate._switching))

    monkeypatch.setattr("torch.profiler.profile", lambda **kw: Prof())
    prof = profiler._profiler_start()
    profiler._profiler_stop(prof, None)
    assert (step, True) in seen
    assert launch_gate._switching is False

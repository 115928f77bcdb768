"""chip_smoke.py's per-frame launch check, on synthetic CUPTI traces.

The check itself runs on the card; here it is fed traces of the shape
``chip_smoke.trace`` returns, to show what it accepts and what it fails:
a record the tracer demonstrably lost (its launch holds fewer device records
than the others) passes, a kernel missing from the graph or launched twice
per frame fails.
"""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PATH = ("fused_arith", "pallas_nms_keep")
GRAPH = 795     # device records of one replay of slice 2's graph
FRAMES = 16


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(per_launch):
    records = {w: sum(rec.get(w, 0) for rec, _ in per_launch)
               for w in ("fused_arith", "int8_matmul", "pallas_nms_keep")}
    return dict(records=records, per_launch=per_launch)


def _exact():
    return [({"fused_arith": 1, "pallas_nms_keep": 1}, GRAPH) for _ in range(FRAMES)]


def test_exact_trace_passes(smoke):
    assert smoke.launch_check(_trace(_exact()), PATH) == 0


@pytest.mark.parametrize("frame", [0, 7, FRAMES - 1])
def test_record_lost_by_the_tracer_passes(smoke, frame):
    per = _exact()
    per[frame] = ({"pallas_nms_keep": 1}, GRAPH - 1)
    assert smoke.launch_check(_trace(per), PATH) == 1


def test_non_path_record_lost_passes(smoke):
    per = _exact()
    per[3] = (per[3][0], GRAPH - 1)
    assert smoke.launch_check(_trace(per), PATH) == 1


@pytest.mark.parametrize("case", ["missing_from_graph", "missing_full_launch",
                                  "two_missing_one_lost", "twice_per_frame", "off_path",
                                  "outside_the_graph"])
def test_launch_faults_fail(smoke, case):
    per = _exact()
    tr = None
    if case == "missing_from_graph":        # the graph has no fused_arith node
        per = [({"pallas_nms_keep": 1}, GRAPH - 1) for _ in range(FRAMES)]
    elif case == "missing_full_launch":     # a launch lacks it yet lost nothing
        per[5] = ({"pallas_nms_keep": 1}, GRAPH)
    elif case == "two_missing_one_lost":
        per[5] = ({}, GRAPH - 1)
    elif case == "twice_per_frame":
        per = [({"fused_arith": 2, "pallas_nms_keep": 1}, GRAPH + 1) for _ in range(FRAMES)]
    elif case == "off_path":
        per[2] = ({"fused_arith": 1, "pallas_nms_keep": 1, "int8_matmul": 1}, GRAPH)
    elif case == "outside_the_graph":       # an eager launch in the window
        tr = _trace(per)
        tr["records"]["fused_arith"] += 1
    with pytest.raises(SystemExit):
        smoke.launch_check(tr or _trace(per), PATH)

"""chip_smoke.py's checks, on synthetic inputs.

The checks run on the card; here they are fed what the card would give, to
show what they accept and what they fail.  The per-frame launch check gets
traces of the shape ``chip_smoke.trace`` returns: a record the tracer
demonstrably lost (its launch holds fewer device records than the others)
passes, a kernel missing from the graph or launched twice per frame fails.
The audio phase's checks get backend stats, wrapper counts, labels and
logits; the upload-wait check gets the frames a sink callback read.
"""

import importlib.util
import pathlib

import numpy as np
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


AUDIO = ("fused_arith",)
AUDIO_GRAPH = 20    # device records of one replay of the audio path's graph


def test_audio_trace_passes(smoke):
    per = [({"fused_arith": 1}, AUDIO_GRAPH) for _ in range(FRAMES)]
    assert smoke.launch_check(_trace(per), AUDIO) == 0


@pytest.mark.parametrize("other", ["pallas_nms_keep", "int8_matmul"])
def test_audio_trace_with_another_kernel_fails(smoke, other):
    per = [({"fused_arith": 1}, AUDIO_GRAPH) for _ in range(FRAMES)]
    per[4] = ({"fused_arith": 1, other: 1}, AUDIO_GRAPH + 1)
    with pytest.raises(SystemExit):
        smoke.launch_check(_trace(per), AUDIO)


def _audio(smoke, frames=64):
    stats = dict(captures=1, replays=frames, warmup_calls=3)
    launches = {"fused_arith": 4, "int8_matmul": 0, "pallas_nms_keep": 0}
    idx = [4] * frames
    rng = np.random.default_rng(0)
    cpu = [rng.standard_normal(smoke.AUDIO_CLASSES).astype(np.float32) for _ in range(8)]
    for c in cpu:
        c[4] = 3.0
    return stats, launches, idx, list(idx), [c.copy() for c in cpu], cpu


def test_audio_checks_pass(smoke):
    stats, launches, got, eager, replay, cpu = _audio(smoke)
    replay[0][0] += 0.5 * smoke.AUDIO_LOGIT_REL * 3.0   # inside the tolerance
    rel = smoke.audio_checks(stats, launches, got, eager, replay, cpu)
    assert 0 < rel <= smoke.AUDIO_LOGIT_REL


@pytest.mark.parametrize("fault", ["two_captures", "replay_missing", "eager_kernel_launch",
                                   "off_path_kernel", "label_differs", "logit_off",
                                   "top1_differs"])
def test_audio_checks_fail(smoke, fault):
    stats, launches, got, eager, replay, cpu = _audio(smoke)
    if fault == "two_captures":
        stats["captures"] = 2
    elif fault == "replay_missing":
        stats["replays"] = 63
    elif fault == "eager_kernel_launch":     # a frame ran eagerly: one launch more
        launches["fused_arith"] = 5
    elif fault == "off_path_kernel":
        launches["pallas_nms_keep"] = 1
    elif fault == "label_differs":
        got[17] = 5
    elif fault == "logit_off":
        replay[3][0] += 2 * smoke.AUDIO_LOGIT_REL * 3.0
    elif fault == "top1_differs":
        replay[2][4], replay[2][7] = replay[2][7], 3.5
    with pytest.raises(SystemExit):
        smoke.audio_checks(stats, launches, got, eager, replay, cpu)


def test_upload_wait_check(smoke):
    sent = [np.arange(12, dtype=np.uint8) + i for i in range(3)]
    smoke.upload_wait_check([s.reshape(3, 4) for s in sent], sent)
    stale = [s.reshape(3, 4) for s in sent]
    stale[1] = np.zeros((3, 4), np.uint8)      # read before its copy landed
    with pytest.raises(SystemExit):
        smoke.upload_wait_check(stale, sent)
    with pytest.raises(SystemExit):
        smoke.upload_wait_check(stale[:2], sent)

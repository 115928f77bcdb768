"""chip_smoke.py's checks, on synthetic inputs.

The checks run on the card; here they are fed what the card would give, to
show what they accept and what they fail.  The per-frame launch check gets
traces of the shape ``chip_smoke.trace`` returns: a record the tracer
demonstrably lost (its launch holds fewer device records than the others)
passes, a kernel missing from the graph or launched twice per frame fails.
The audio phase's checks get backend stats, wrapper counts, labels and
logits; the upload-wait check gets the frames a sink callback read.  The
quant phase's check gets traces whose launches hold cuBLASLt's int8 GEMM
records (35 a frame): one missing, or none, fails; its device-time split
gets profiler events.  The pose phase's keypoint check gets heatmaps and
keypoint lists; its conv check runs a small pose net with the CPU standing
in for the card, and fails a conv lane or a heatmap moved; the recurrence
phase's checks get backend stats and copy counts.  The cascade phase's
checks get detections, a reference's whole anchor ranking and logits (a far
anchor, class, box or label fails; scores within the margin may swap), its
dynbatch rows each frame's batch-1 reference and the next frame's (a
swapped row fails, and so do frames too alike to tell apart); the element
cascade's and the app phase's get output frames, sink pts, logits and the
CLI's output.  The transformer family's checks get backend stats and wrapper
counts (the ViT path), card and CPU logits (a drift past the tolerance or a
top-1 flip past a clear lead fails; a close call may swap), config 4c's
outputs against its eager loop (one bit apart fails) and config 4d's
streams served among others, alone and eagerly (a bit apart, or a stream's
outputs in another's place, fails).  The query phase's checks get coalesced
groups and in-process rows (a row a bit apart, two clients' rows swapped or
a missing chunk fails), admission counts (a request neither delivered nor
shed, nothing shed, the server's and the client's counts apart, an untyped
failure or a changed frame fails) and wire-fault outcomes (a drop or a torn
frame must heal bit for bit; a corrupted byte may change at most the
injected frames).  The stream phase's host models of ``tensor_if`` and
``tensor_rate`` are held to the port's element and to the JAX package's
rate cases; its counter check fails on a count apart, its checksum check on
one byte changed or a frame missing.  The fleet phase's trace check gets a
trace's joined records: a worker span outside the router's by more than
the clock offset's error bound, a device span after its serve span or a
broken parent link fails.
"""

import importlib.util
import json
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


# -- the obs phase ---------------------------------------------------------------


def _records():
    """Two frames' span records as ``obs.spans`` writes them: on the
    source's thread conv's span holds u's, on the queue's thread f's holds
    dec's, which holds out's.  (ph, ts, dur, thread, name, cat, trace,
    span, parent, args), times in ns."""
    recs = []
    for k, t in enumerate((0, 4_000_000)):
        root, base = 100 + k, 10 * (k + 1)
        recs += [("i", t, 0, "src:src", "src.push", "source", 1, root, 0, None),
                 ("X", t + 1000, 300_000, "src:src", "conv", "dispatch", 1, base, root, None),
                 ("X", t + 2000, 200_000, "src:src", "u", "dispatch", 1, base + 1, base, None),
                 ("X", t + 900_000, 2_000_000, "queue:q", "f", "dispatch", 1, base + 2, root,
                  None),
                 ("X", t + 2_500_000, 400_000, "queue:q", "dec", "dispatch", 1, base + 3,
                  base + 2, None),
                 ("X", t + 2_600_000, 100_000, "queue:q", "out", "dispatch", 1, base + 4,
                  base + 3, None),
                 ("C", t + 500_000, 0, "src:src", "q depth", "queue", 0, 0, 0, 1)]
    return recs


def test_span_split(smoke):
    elements, threads = smoke.span_split(_records(), 2)
    assert elements == {
        "conv": {"thread": "src:src", "span_ms": 0.3, "self_ms": pytest.approx(0.1)},
        "u": {"thread": "src:src", "span_ms": 0.2, "self_ms": 0.2},
        "f": {"thread": "queue:q", "span_ms": 2.0, "self_ms": 1.6},
        "dec": {"thread": "queue:q", "span_ms": 0.4, "self_ms": pytest.approx(0.3)},
        "out": {"thread": "queue:q", "span_ms": 0.1, "self_ms": 0.1}}
    assert threads == {"src:src": {"period_ms": 4.0, "in_elements_ms": 0.3},
                       "queue:q": {"period_ms": 4.0, "in_elements_ms": 2.0}}


def test_scraped_latency_count(smoke):
    text = "\n".join([
        '# TYPE nnstpu_e2e_latency_ms histogram',
        'nnstpu_e2e_latency_ms_bucket{pipeline="obs_a",src="src",sink="out",le="+Inf"} 64',
        'nnstpu_e2e_latency_ms_count{pipeline="obs_a",src="src",sink="out"} 64',
        'nnstpu_e2e_latency_ms_count{pipeline="obs_ab",src="src",sink="out"} 3'])
    assert smoke.scraped_latency_count(text, "obs_a") == 64
    assert smoke.scraped_latency_count(text, "obs_ab") == 3
    assert smoke.scraped_latency_count(text, "obs_b") is None


@pytest.mark.parametrize("host_ops", [5.0, 79 / 16])   # a runtime record lost by CUPTI
def test_obs_checks_pass(smoke, host_ops):
    smoke.obs_checks(64, 64, 64, host_ops, 1.30, 1.33)


@pytest.mark.parametrize("fault", ["latency_missed_a_frame", "scrape_missed_a_frame",
                                   "series_missing", "host_op_more", "invoke_enqueue_only"])
def test_obs_checks_fail(smoke, fault):
    args = dict(delivered=64, latency=64, scraped=64, host_ops=5.0, invoke_p50_ms=1.30,
                busy_ms=1.33)
    if fault == "latency_missed_a_frame":
        args["latency"] = 63
    elif fault == "scrape_missed_a_frame":
        args["scraped"] = 63
    elif fault == "series_missing":
        args["scraped"] = None
    elif fault == "host_op_more":       # a tracer read one frame's tensor: a copy more
        args["host_ops"] = 81 / 16
    elif fault == "invoke_enqueue_only":  # block_outputs did not wait
        args["invoke_p50_ms"] = 0.05
    with pytest.raises(SystemExit):
        smoke.obs_checks(**args)


# -- the quant phase: 35 int8 GEMM records and one fused_arith a launch ------

GEMM_NAMES = ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_64x64_128x6_tn_align16>"
              "(cutlass_80_tensorop_i16832gemm_s8_64x64_128x6_tn_align16::Params)",
              "sm90_xmma_gemm_i8i32_i8i32_i32_tn_n_tilesize256x128x128_warpgroupsize2x1x1_"
              "execute_segment_k_off_kernel__5x_cublas")
OTHER_NAMES = ("void at::native::vectorized_elementwise_kernel<4, at::native::round_kernel_cuda("
               "at::TensorIteratorBase&)::{lambda()#1}>", "conv2d_c1_k1_nhwc",
               "void fused_arith_kernel<unsigned char, float, true>(...)")


def _quant_trace(gemms=(33, 2), fused=1, head=0, frames=FRAMES):
    names = {GEMM_NAMES[0]: gemms[0], GEMM_NAMES[1]: gemms[1], OTHER_NAMES[0]: 35,
             OTHER_NAMES[1]: 17}
    rec = {"fused_arith": fused}
    if head:
        rec["int8_matmul"] = head
    total = sum(names.values()) + fused + head
    per = [(dict(rec), total) for _ in range(frames)]
    return dict(_trace(per), names_per_launch=[dict(names) for _ in range(frames)],
                calls={"cudaGraphLaunch": frames, "cudaMemcpyAsync": 4 * frames})


def test_quant_trace_passes(smoke):
    assert smoke.int8_gemms({GEMM_NAMES[0]: 3, GEMM_NAMES[1]: 2, OTHER_NAMES[0]: 9}) == 5
    tr = _quant_trace()
    assert smoke.quant_checks(tr, 35, ("fused_arith",)) == tr["per_launch"][0][1]
    tr = _quant_trace(head=1)
    smoke.quant_checks(tr, 35, ("fused_arith", "int8_matmul"))


@pytest.mark.parametrize("lost", ["first_kernel", "gemm", "runtime_call"])
def test_quant_trace_passes_records_the_tracer_lost(smoke, lost):
    """CUPTI drops a record now and then (seen on the H100: the first
    launch of a traced int8 SSD run without its fused_arith record, one
    device record short): a launch one record short may lack that record,
    and a runtime call's record may go missing."""
    tr = _quant_trace()
    rec, total = tr["per_launch"][0]
    if lost == "first_kernel":
        tr["per_launch"][0] = ({}, total - 1)
    elif lost == "gemm":
        tr["names_per_launch"][3][GEMM_NAMES[1]] -= 1
        tr["per_launch"][3] = (rec, total - 1)
    else:
        tr["calls"]["cudaMemcpyAsync"] -= 1
    assert smoke.quant_checks(tr, 35, ("fused_arith",)) == total


@pytest.mark.parametrize("fault", ["gemm_missing", "float_trunk", "extra_gemm", "head_missing",
                                   "no_launch", "host_op", "more_missing_than_lost",
                                   "runtime_calls_lost"])
def test_quant_trace_faults_fail(smoke, fault):
    """A launch one int8 GEMM short (a conv that ran in float), a trunk with
    no int8 GEMM at all, one GEMM too many, the int8 head missing, a trace
    with no graph launch, a sixth host-issued operation, a launch lacking
    more records than the tracer lost from it, and runtime-call records
    short by more than half a frame all fail."""
    kernels = ("fused_arith",)
    if fault == "gemm_missing":
        tr = _quant_trace()
        tr["names_per_launch"][5][GEMM_NAMES[0]] -= 1
    elif fault == "float_trunk":
        tr = _quant_trace(gemms=(0, 0))
    elif fault == "extra_gemm":
        tr = _quant_trace(gemms=(34, 2))
    elif fault == "head_missing":
        tr, kernels = _quant_trace(), ("fused_arith", "int8_matmul")
    elif fault == "host_op":
        tr = _quant_trace()
        tr["calls"]["cudaLaunchKernel"] = 1  # a kernel launched outside the graph
    elif fault == "more_missing_than_lost":  # one record lost, two missing
        tr = _quant_trace()
        tr["names_per_launch"][0][GEMM_NAMES[0]] -= 1
        tr["per_launch"][0] = ({}, tr["per_launch"][0][1] - 1)
    elif fault == "runtime_calls_lost":  # more than half a frame's worth
        tr = _quant_trace()
        tr["calls"]["cudaMemcpyAsync"] -= FRAMES // 2 + 1
    else:
        tr = dict(_trace([]), names_per_launch=[], calls={})
    with pytest.raises(SystemExit):
        smoke.quant_checks(tr, 35, kernels)


def test_split_by_step(smoke):
    """A kernel's time goes to the class of the nearest enclosing step range
    of the runtime call that launched it (the same id), else to "other";
    a range's own span on the device timeline is no kernel."""
    from types import SimpleNamespace as E

    from torch.autograd import DeviceType

    def cpu(name, id_, parent=None):
        return E(name=name, id=id_, cpu_parent=parent, device_type=DeviceType.CPU)

    def gpu(id_, us):
        return E(name="k", id=id_, cpu_parent=None, device_type=DeviceType.CUDA,
                 device_time_total=us)

    gemm = cpu("int8 GEMM", 1)
    quant = cpu("quantize and rescale", 2)
    dw = cpu("depthwise conv", 3)
    events = [gemm, quant, dw,
              cpu("cudaLaunchKernel", 10, cpu("aten::_int_mm", 4, gemm)),
              cpu("cudaLaunchKernel", 11, cpu("aten::round", 5, quant)),
              cpu("cudaLaunchKernel", 12, cpu("aten::convolution", 6, dw)),
              cpu("cudaLaunchKernel", 13, cpu("aten::add", 7)),
              gpu(10, 400.0), gpu(11, 30.0), gpu(11, 20.0), gpu(12, 100.0), gpu(13, 7.0),
              gpu(99, 1.0), E(name="int8 GEMM", id=1, cpu_parent=None,
                              device_type=DeviceType.CUDA, device_time_total=900.0)]
    split = smoke.split_by_step(events)
    assert split == {"int8 GEMM": 0.4, "quantize and rescale": 0.05, "depthwise conv": 0.1,
                     "other": 0.008}


def test_keypoints_of_takes_the_first_of_equal_maxima(smoke):
    hm = np.full((4, 5, 14), 0.25, np.float32)
    hm[2, 1, 3] = hm[3, 4, 3] = 0.75  # the row-major first is (x=1, y=2)
    kps = smoke.keypoints_of(np, hm)
    assert kps[3] == (1, 2, 0.75) and kps[0] == (0, 0, 0.25) and len(kps) == 14


@pytest.mark.parametrize("fault", [None, "cell", "score", "cpu_cell"])
def test_keypoint_check(smoke, fault):
    """The decoded keypoints must be the eager heatmaps' argmax, cells and
    scores; against the CPU forward only where the top-1 leads by more than
    the margin: a CPU cell that differs on a channel within it passes."""
    rng = np.random.default_rng(3)
    hm = rng.random((14, 14, 14)).astype(np.float32)
    got = smoke.keypoints_of(np, hm)
    cpu = hm.copy()
    flat = cpu.reshape(-1, 14)
    lead = int(np.argmax(flat[:, 0]))
    flat[lead, 0] = flat[:, 0].max() + 0.5  # channel 0 leads by far on the CPU
    flat[(lead + 1) % flat.shape[0], 5] = flat[:, 5].max() + 1e-3  # channel 5: within margin
    if fault == "cell":
        got[2] = ((got[2][0] + 1) % 14, got[2][1], got[2][2])
    elif fault == "score":
        got[2] = (got[2][0], got[2][1], got[2][2] + 1e-3)
    elif fault == "cpu_cell":
        flat[lead, 0] = 0.0
        flat[(lead + 3) % flat.shape[0], 0] = 2.0  # the CPU's cell moves, by far
    if fault in ("cell", "score", "cpu_cell"):
        with pytest.raises(SystemExit):
            smoke.keypoint_check(np, got, hm, cpu, 0.03)
    else:
        assert smoke.keypoint_check(np, got, hm, cpu, 0.03) >= 1
        assert smoke.keypoint_check(np, got, hm, None, 0.03) == 0


def test_memcpy_counts(smoke):
    names = {"Memcpy DtoH (Device -> Pageable)": 2, "Memcpy HtoD (Pageable -> Device)": 16,
             "Memcpy DtoD (Device -> Device)": 62, "void at::native::copy_kernel": 9}
    assert smoke.memcpy_counts(names) == {"DtoH": 2, "HtoD": 16, "DtoD": 62}


@pytest.mark.parametrize("fault", [None, "recapture", "replays", "tracer_copy", "dtoh"])
def test_recurrence_checks(smoke, fault):
    stats = {"captures": 2 if fault == "recapture" else 1,
             "replays": 199 if fault == "replays" else 200}
    args = (stats, 200, 1 if fault == "tracer_copy" else 0, 3 if fault == "dtoh" else 0)
    if fault is None:
        smoke.recurrence_checks(*args)
    else:
        with pytest.raises(SystemExit):
            smoke.recurrence_checks(*args)


@pytest.mark.parametrize("fault", [None, "conv", "sigmoid"])
def test_pose_conv_check(smoke, fault):
    """Every bfloat16 conv of the pose net within its accumulation bounds,
    the rest bit for bit against the CPU forward fed the same conv outputs
    (here the "card" is the CPU too): a lane moved by 1/4 in one conv, or a
    heatmap moved after the last conv, fails."""
    import torch

    from nnstreamer_tpu_torch.models import posenet

    params = posenet.init_params(0, 0.35, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (64, 64, 3))
                         .astype(np.float32))
    calls = []

    def apply(p, x):
        if p is not params:
            return posenet.apply(p, x)
        if fault == "sigmoid":
            return posenet.apply(p, x) + 2.0 ** -10
        if fault == "conv":  # the 20th conv, one lane
            F = torch.nn.functional
            real = F.conv2d

            def conv2d(*a, **kw):
                y = real(*a, **kw)
                calls.append(1)
                if len(calls) == 20:
                    y = y.clone()
                    y[0, 0, 0, 0] += 0.25
                return y

            F.conv2d = conv2d
            try:
                return posenet.apply(p, x)
            finally:
                F.conv2d = real
        return posenet.apply(p, x)

    cpu = {k: v for k, v in params.items()}  # the same leaves, another tree
    if fault is None:
        assert smoke.pose_conv_check(torch, apply, params, cpu, x) == (40, 215776, 224)
    else:
        with pytest.raises(SystemExit):
            smoke.pose_conv_check(torch, apply, params, cpu, x)


# The batch phase's checks (configs 5 and 1d).

def _batch_stats(captures=1, replays=24):
    return dict(captures=captures, replays=replays, warmup_calls=3)


@pytest.mark.parametrize("case,ok", [
    ("exact", True), ("two captures", False), ("a replay short", False),
    ("int8 launched off the path", False), ("an eager call counted", False)])
def test_batch_capture_check(smoke, case, ok):
    stats = _batch_stats(captures=2 if case == "two captures" else 1,
                         replays=23 if case == "a replay short" else 24)
    launches = {"fused_arith": 4, "int8_matmul": 4 if case == "int8 launched off the path" else 0,
                "pallas_nms_keep": 0}
    if case == "an eager call counted":
        launches["fused_arith"] = 5
    if ok:
        smoke.batch_capture_check(stats, 24, launches, ("fused_arith",))
    else:
        with pytest.raises(SystemExit):
            smoke.batch_capture_check(stats, 24, launches, ("fused_arith",))


def _rows(rounds=3, n=4):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((n, 10)).astype(np.float32) for _ in range(rounds)]


@pytest.mark.parametrize("case", ["exact", "swapped streams", "late round", "one ulp",
                                  "a frame short"])
def test_stream_check(smoke, case):
    """Each stream's frames are the eager forward's rows of its index, in
    round order, bit for bit."""
    eager = _rows()
    got = {i: [eager[r][i].copy() for r in range(3)] for i in range(4)}
    if case == "swapped streams":
        got[0], got[1] = got[1], got[0]
    elif case == "late round":
        got[2] = [got[2][1], got[2][0], got[2][2]]
    elif case == "one ulp":
        got[3][2] = np.nextafter(got[3][2], np.float32(np.inf))
    elif case == "a frame short":
        got[1] = got[1][:2]
    if case == "exact":
        smoke.stream_check(np, got, eager, 3)
    else:
        with pytest.raises(SystemExit):
            smoke.stream_check(np, got, eager, 3)


def test_batch1_check(smoke):
    one = [np.array([1.0, 5.0, -2.0], np.float32), np.array([3.0, 0.5, 0.0], np.float32)]
    near = [o + np.float32(0.1) for o in one]  # 0.1 of 5 and of 3
    worst, control, labels = smoke.batch1_check(np, near, one, 1 / 16)
    assert worst == pytest.approx(0.1 / 3) and labels == 2
    assert control == pytest.approx(4.4 / 5)  # row 1 against frame 0: 0.6 - 5.0, of 5
    with pytest.raises(SystemExit):  # beyond the tolerance
        smoke.batch1_check(np, near, one, 1 / 32)
    flipped = [one[0], np.array([3.0, 3.1, 0.0], np.float32)]
    with pytest.raises(SystemExit):  # the top-1 label moved
        smoke.batch1_check(np, flipped, one, 1.0)


@pytest.mark.parametrize("case", ["swapped", "blind"])
def test_batch1_check_control(smoke, capsys, case):
    """Two rows swapped fail the limit; frames whose batch-1 forwards lie
    within the limit of each other fail the control: a swap would pass."""
    one = [np.array([1.0, 5.0, -2.0], np.float32), np.array([3.0, 0.5, 0.0], np.float32),
           np.array([0.0, 0.2, 4.0], np.float32)]
    if case == "swapped":
        assert smoke.batch1_check(np, list(one), one, 1 / 16)[0] == 0.0
        rows, rel, why = [one[1], one[0], one[2]], 1 / 16, "frame 0: batched row"
    else:
        one[1] = one[0] + np.float32(0.01)  # two frames alike to 0.002 of 5
        rows, rel, why = list(one), 1 / 64, "control"
    with pytest.raises(SystemExit):
        smoke.batch1_check(np, rows, one, rel)
    assert why in capsys.readouterr().err


@pytest.mark.parametrize("case,ok", [
    ("exact", True), ("a capture while playing", False), ("a bucket missing", False),
    ("a frame lost", False), ("out of order", False), ("a bucket off the ladder", False)])
def test_dyn_checks(smoke, case, ok):
    report = {"compiled": [{"label": f"bucket{b}"} for b in (1, 2, 4, 8)]}
    before, after = 4, 4
    buckets = [1, 8, 8, 4, 2, 8]
    pts = list(range(20))
    if case == "a capture while playing":
        after = 5
    elif case == "a bucket missing":
        before, report = 3, {"compiled": report["compiled"][:3]}
    elif case == "a frame lost":
        pts = pts[:-1]
    elif case == "out of order":
        pts[3], pts[4] = pts[4], pts[3]
    elif case == "a bucket off the ladder":
        buckets[2] = 6
    if ok:
        hist = smoke.dyn_checks(np, before, after, report, buckets, pts, 20)
        assert hist == {"1": 1, "2": 1, "4": 1, "8": 3}
    else:
        with pytest.raises(SystemExit):
            smoke.dyn_checks(np, before, after, report, buckets, pts, 20)


def _dyn_trace(per_launch):
    return dict(per_launch=per_launch)


@pytest.mark.parametrize("case,ok", [
    ("exact", True), ("a record lost", True), ("no int8 at a bucket", False),
    ("nms_keep launched", False), ("a launch short", False)])
def test_dyn_launch_check(smoke, case, ok):
    """Config 1d's trace: a graph launch a batch, each with one
    fused_arith and one int8_matmul record; graphs of different buckets
    hold different record counts, so a lost record is judged within its
    bucket."""
    buckets = [8, 8, 4, 8, 1]
    sizes = {8: 700, 4: 650, 1: 600}
    per = [({"fused_arith": 1, "int8_matmul": 1}, sizes[b]) for b in buckets]
    if case == "a record lost":
        per[1] = ({"fused_arith": 1}, 699)
    elif case == "no int8 at a bucket":
        per[4] = ({"fused_arith": 1}, 600)
    elif case == "nms_keep launched":
        per[2] = ({"fused_arith": 1, "int8_matmul": 1, "pallas_nms_keep": 1}, 651)
    elif case == "a launch short":
        per = per[:-1]
    if ok:
        assert smoke.dyn_launch_check(_dyn_trace(per), buckets) == \
            {8: 3 - (case == "a record lost"), 4: 1, 1: 1}
    else:
        with pytest.raises(SystemExit):
            smoke.dyn_launch_check(_dyn_trace(per), buckets)


@pytest.mark.parametrize("buckets,first,retake", [
    ([1, 8, 1, 4], {"int8_matmul": 1}, False),  # bucket 1 launched again: measurable
    ([1, 8, 4, 8], {"int8_matmul": 1}, True),   # bucket 1's only launch lost its normalize
    ([1, 8, 4, 8], {"fused_arith": 1, "int8_matmul": 1}, False),  # nothing lacking
    ([8, 8, 4, 1], {"int8_matmul": 1}, False)])  # bucket 8 launched again
def test_dyn_loss_unmeasured(smoke, buckets, first, retake):
    """Config 1d's coverage trace is taken again only when its first launch
    lacks a path record and is its bucket's only launch."""
    per = [(first, 599)] + [({"fused_arith": 1, "int8_matmul": 1}, 600)] * (len(buckets) - 1)
    assert smoke.dyn_loss_unmeasured(_dyn_trace(per), buckets) is retake


def test_batch_strings_name_the_path(smoke):
    desc = smoke.batch_desc(4, "m.npz", "build")
    assert desc.count("datasrc name=cam") == 4 and desc.count("tensor_sink") == 4
    assert "tensor_batch" in desc and "tensor_unbatch" in desc and "batch=4" in desc
    assert "acceleration=pallas" in desc and "tensor_upload name=u" in desc
    d = smoke.dyn_desc()
    assert f"tensor_dynbatch name=dyn max_batch={smoke.DYN_MAX_BATCH}" in d
    assert d.index("tensor_dynbatch") < d.index("tensor_transform") < d.index("tensor_filter")


# -- config 2c and the app surface (the cascade and app phases) -------------

def _dets(rng, k=4):
    d = rng.uniform(0, 1, (k, 6)).astype(np.float32)
    d[:, 4] = rng.integers(1, 6, k)
    d[:, 5] = 1.0
    return d


@pytest.mark.parametrize("case,ok", [
    ("bitwise", True), ("within the tolerance", True), ("beyond the tolerance", False),
    ("a class changed", False), ("a top-1 label changed", False), ("misshapen", False)])
def test_cascade_replay_check(smoke, case, ok):
    rng = np.random.default_rng(0)
    want = [(_dets(rng), rng.standard_normal((4, 10)).astype(np.float32)) for _ in range(2)]
    got = [(d.copy(), l.copy()) for d, l in want]
    if case == "within the tolerance":
        got[1][1][0, 0] += 1e-5
    elif case == "beyond the tolerance":
        got[1][1][0, 0] += 0.1
    elif case == "a class changed":
        got[0][0][2, 4] += 1
    elif case == "a top-1 label changed":
        i = int(got[0][1][3].argmin())
        got[0][1][3, i] = got[0][1][3].max() + 1e-4 * abs(got[0][1][3].max())
    elif case == "misshapen":
        got[0] = (got[0][0][:3], got[0][1])
    if ok:
        exact, rel = smoke.cascade_replay_check(np, got, want, 1e-3)
        assert exact == (case == "bitwise") and (rel > 0) == (case != "bitwise")
    else:
        with pytest.raises(SystemExit):
            smoke.cascade_replay_check(np, got, want, 1e-3)


LIMITS = dict(score=1e-3, box_atol=1 / 32, box_rtol=1 / 16, logit_rel=1 / 16, label_margin=1 / 32)


def _ranking(rng, p=40, labels=5):
    """A reference's whole ranking: rows [x, y, w, h, class, score], best
    first (4 anchors at 1.0, two close behind, the rest far), and each
    ranked anchor's scores by class (its class on top)."""
    ranked = rng.uniform(0.05, 0.95, (p, 6)).astype(np.float32)
    ranked[:, 4] = rng.integers(1, labels + 1, p)
    ranked[:, 5] = np.concatenate([np.ones(4), [1.0 - 1e-4] * 2,
                                   np.linspace(0.4, 0.1, p - 6)]).astype(np.float32)
    by_class = rng.uniform(0, 0.05, (p, labels)).astype(np.float32)
    by_class[np.arange(p), ranked[:, 4].astype(int) - 1] = ranked[:, 5]
    return ranked, by_class


def _cascade_frame(rng, k=4, classes=10):
    ranked, by_class = _ranking(rng)
    logits = rng.standard_normal((k, classes)).astype(np.float32)
    logits[:, 3] += 5  # a clear top-1
    return dict(dets=ranked[:k].copy(), logits=logits.copy(), ranked=ranked, by_class=by_class,
                ref_logits=logits)


@pytest.mark.parametrize("case,ok", [
    ("equal", True), ("close anchors swapped", True), ("a tied class", True),
    ("boxes a bfloat16 step apart", True), ("logits within the tolerance", True),
    ("a far anchor picked", False), ("a far class", False), ("a box moved", False),
    ("logits apart", False), ("a top-1 label changed", False)])
def test_cascade_check(smoke, case, ok):
    f = _cascade_frame(np.random.default_rng(1))
    if case == "close anchors swapped":
        f["dets"][1] = f["ranked"][4]  # 1e-4 below rank 1's score
    elif case == "a tied class":
        c = int(f["dets"][0, 4])
        other = 1 if c != 1 else 2
        f["by_class"][0, other - 1] = 1.0 - 1e-5
        f["dets"][0, 4] = other
    elif case == "boxes a bfloat16 step apart":
        f["dets"][:, :4] *= 1 + 1 / 128
    elif case == "logits within the tolerance":
        f["logits"] += 0.01
    elif case == "a far anchor picked":
        f["dets"][2] = f["ranked"][10]  # score 0.4
    elif case == "a far class":
        c = int(f["dets"][0, 4])
        f["dets"][0, 4] = 1 if c != 1 else 2
    elif case == "a box moved":
        f["dets"][3, 2] += 0.2
    elif case == "logits apart":
        f["logits"][2, 0] += 2.0
    elif case == "a top-1 label changed":
        f["logits"][1, 7] = f["logits"][1, 3] + 0.01
    args = (np, f["dets"], f["logits"], f["ranked"], f["by_class"], f["ref_logits"], LIMITS)
    r, faults = smoke.cascade_faults(*args)
    assert bool(faults) != ok
    if ok:
        assert smoke.cascade_check(*args, "frame") == r
        assert r["ranks_swapped"] == (case == "close anchors swapped")
        assert r["ranks_compared"] + r["ranks_swapped"] == 4 and r["labels_compared"] == 4
        assert r["classes_swapped"] == (case == "a tied class")
    else:
        with pytest.raises(SystemExit):
            smoke.cascade_check(*args, "frame")


def _batch1(rng, n=3, k=4, classes=10):
    """Rows of ``n`` frames and each frame's batch-1 reference, with the
    next frame's crops (the control) classifying elsewhere."""
    rows, refs, logits = [], [], []
    for _ in range(n):
        ranked, by_class = _ranking(rng)
        lg = rng.standard_normal((k, classes)).astype(np.float32)
        lg[:, rng.integers(0, classes)] += 5
        rows.append((ranked[:k].copy(), lg.copy()))
        refs.append([ranked, by_class, lg])
        logits.append(lg)
    for i, r in enumerate(refs):
        r.append(logits[(i + 1) % n])
    return rows, refs


@pytest.mark.parametrize("case,ok", [("sound", True), ("a row off", False),
                                     ("two rows swapped", False), ("frames alike", False)])
def test_cascade_batch1_check(smoke, case, ok):
    rows, refs = _batch1(np.random.default_rng(3))
    if case == "a row off":
        rows[1][0][2, 1] += 0.2
    elif case == "two rows swapped":
        rows[0], rows[1] = rows[1], rows[0]
    elif case == "frames alike":  # every frame ranks and classifies as the first
        refs = [[refs[0][0], refs[0][1], r[2], r[2]] for r in refs]
        rows = [(refs[0][0][:4].copy(), r[2].copy()) for r in refs]
    refs = [tuple(r) for r in refs]
    if ok:
        sound, control = smoke.cascade_batch1_check(np, rows, refs, LIMITS)
        assert sound["ranks_compared"] == 12 and sound["box_abs_err"] == 0
        assert control["min_faults"] > 0 and control["min_logit_rel_err"] > LIMITS["logit_rel"]
    else:
        with pytest.raises(SystemExit):
            smoke.cascade_batch1_check(np, rows, refs, LIMITS)


def test_cascade_reference_is_the_models_ranking(smoke):
    """``cascade_reference`` and ``cascade_crop_logits`` on a small cascade
    on the CPU: the ranking's first k rows are the model's detections bit
    for bit, each ranked anchor's best class score its score, and the crops'
    logits the model's."""
    import torch

    from nnstreamer_tpu_torch.models import cascade, ssd_mobilenet

    m = cascade.build_detect_classify(num_labels=11, det_size=96, k=4, crop_size=32,
                                      num_classes=16, width_mult=0.35, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (96, 96, 3)).astype(np.float32))
    with torch.inference_mode():
        dets, logits = (t.numpy() for t in m(x))
    ranked, by_class = smoke.cascade_reference(torch, m, x, ssd_mobilenet.generate_priors(96))
    assert ranked.shape == (ssd_mobilenet.num_priors(96), 6)
    assert np.array_equal(ranked[:4], dets)
    assert np.array_equal(by_class.max(axis=-1), ranked[:, 5])
    assert np.all(np.diff(ranked[:, 5]) <= 0)
    crop_cascade = smoke.CASCADE_CROP
    try:
        smoke.CASCADE_CROP = 32
        np.testing.assert_allclose(smoke.cascade_crop_logits(torch, m, x, dets), logits,
                                   rtol=0, atol=1e-6)
    finally:
        smoke.CASCADE_CROP = crop_cascade


@pytest.mark.parametrize("case,ok", [("equal", True), ("one bit", False), ("a frame lost", False),
                                     ("pts moved", False), ("a region lost", False)])
def test_element_cascade_check(smoke, case, ok):
    rng = np.random.default_rng(2)
    cpu = [(i, rng.integers(0, 1000, (2, 4)).astype(np.int32), 2) for i in range(6)]
    card = [(p, o.copy(), r) for p, o, r in cpu]
    if case == "one bit":
        card[3][1][1, 2] ^= 1
    elif case == "a frame lost":
        card = card[:-1]
    elif case == "pts moved":
        card[2] = (7, card[2][1], 2)
    elif case == "a region lost":
        card[0] = (0, card[0][1], 1)
    if ok:
        smoke.element_cascade_check(np, card, cpu)
    else:
        with pytest.raises(SystemExit):
            smoke.element_cascade_check(np, card, cpu)


@pytest.mark.parametrize("case,ok", [("as sent", True), ("a closed frame passed", False),
                                     ("the switch missed", False), ("a frame lost", False)])
def test_app_checks(smoke, case, ok):
    a, b = list(range(8)), list(range(16, 32))
    if case == "a closed frame passed":
        a = a + [9]
    elif case == "the switch missed":
        a, b = a + [16], b[1:]
    elif case == "a frame lost":
        b = b[:-1]
    if ok:
        smoke.app_checks(a, b, 32, range(8, 16), 16)
    else:
        with pytest.raises(SystemExit):
            smoke.app_checks(a, b, 32, range(8, 16), 16)


@pytest.mark.parametrize("case,ok", [("bitwise", True), ("within", True), ("beyond", False),
                                     ("top-1 moved", False), ("none compared", False)])
def test_logits_check(smoke, case, ok):
    rng = np.random.default_rng(3)
    want = [rng.standard_normal(1001).astype(np.float32) for _ in range(3)]
    got = [w.copy() for w in want]
    if case == "within":
        got[1][5] += 1e-4 * np.abs(want[1]).max()
    elif case == "beyond":
        got[1][5] += 0.01 * np.abs(want[1]).max()
    elif case == "top-1 moved":
        got[2][int(want[2].argmin())] = want[2].max() + 1e-6
    elif case == "none compared":
        got, want = [], []
    if ok:
        exact, rel = smoke.logits_check(np, got, want, 1e-3)
        assert exact == (case == "bitwise")
    else:
        with pytest.raises(SystemExit):
            smoke.logits_check(np, got, want, 1e-3)


CLI_OUT = "".join(f"out: frame {i} pts={i * 33333333} float32(1001,)\n" for i in range(1, 9)) + \
    "EOS after 1.23s; 8 sink frames\n"


@pytest.mark.parametrize("case,ok", [("ok", True), ("rc 1", False), ("a report missing", False),
                                     ("no EOS line", False), ("wrong output", False)])
def test_cli_check(smoke, case, ok):
    rc, out = 0, CLI_OUT
    if case == "rc 1":
        rc = 1
    elif case == "a report missing":
        out = "".join(ln + "\n" for ln in out.splitlines() if not ln.startswith("out: frame 4 "))
    elif case == "no EOS line":
        out = out.replace("EOS after 1.23s; 8 sink frames\n", "")
    elif case == "wrong output":
        out = out.replace("float32(1001,)", "float32(10,)")
    if ok:
        smoke.cli_check(rc, out, "", 8)
    else:
        with pytest.raises(SystemExit):
            smoke.cli_check(rc, out, "", 8)


def test_dyn_checks_with_a_smaller_ladder(smoke):
    report = {"compiled": [{"label": f"bucket{b}"} for b in (1, 2, 4)]}
    assert smoke.dyn_checks(np, 3, 3, report, [4, 4, 2], list(range(10)), 10, max_batch=4) == \
        {"1": 0, "2": 1, "4": 2}
    with pytest.raises(SystemExit):  # bucket 8 is off a ladder of 4
        smoke.dyn_checks(np, 3, 3, report, [4, 8], list(range(12)), 12, max_batch=4)


def test_cascade_and_app_strings_name_the_path(smoke):
    d = smoke.cascade_desc(64, "c.npz")
    assert "model=c.npz" in d and "builder=cascade:build_detect_classify" in d
    assert f"k={smoke.CASCADE_K}" in d and f"crop_size={smoke.CASCADE_CROP}" in d
    assert d.index("acceleration=pallas") < d.index("tensor_upload name=u") < \
        d.index("tensor_filter")
    d = smoke.dyn_desc(smoke.CASCADE_DYN_MAX_BATCH)
    assert f"max_batch={smoke.CASCADE_DYN_MAX_BATCH}" in d and "tensor_dynunbatch" in d
    a = smoke.app_desc("m.npz")
    assert a.index("appsrc name=in") < a.index("tensor_upload") < a.index("valve name=v") < \
        a.index("tensor_filter") < a.index("output-selector name=s")
    assert "int8_head=1" in a and "s.src_1 ! tensor_sink name=b" in a
    assert f"num-buffers={smoke.CLI_FRAMES}" in smoke.cli_desc("m.npz")


# -- the transformer family's checks (ViT-B/16, config 4c, config 4d) -----------------

VIT_STATS = {"captures": 1, "replays": 64, "warmup_calls": 3}
VIT_LAUNCHES = {"fused_arith": 4, "int8_matmul": 0, "pallas_nms_keep": 0}


@pytest.mark.parametrize("case, ok", [
    ("exact", True), ("recapture", False), ("replays", False), ("fused_in_replay", False),
    ("int8_matmul", False), ("nms", False)])
def test_vit_checks(smoke, case, ok):
    stats, launches = dict(VIT_STATS), dict(VIT_LAUNCHES)
    if case == "recapture":
        stats["captures"] = 2
    elif case == "replays":
        stats["replays"] = 63
    elif case == "fused_in_replay":
        launches["fused_arith"] = 68  # the normalize ran outside the capture
    elif case == "int8_matmul":
        launches["int8_matmul"] = 1
    elif case == "nms":
        launches["pallas_nms_keep"] = 4
    if ok:
        smoke.vit_checks(stats, launches, 64)
    else:
        with pytest.raises(SystemExit):
            smoke.vit_checks(stats, launches, 64)


def _logits(seed, n=4, classes=1000):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(classes).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("case, ok", [
    ("equal", True), ("drift_within", True), ("close_call_swap", True), ("drift", False),
    ("top1_flip", False), ("far_swap", False), ("frame_order", False)])
def test_vit_cpu_check(smoke, case, ok):
    rel = 1 / 32
    cpu = _logits(1)
    for c in cpu:  # each frame's top-1 leads clearly
        c[int(c.argmax())] += np.float32(4 * rel) * np.abs(c).max()
    card = [c.copy() for c in cpu]
    if case == "drift_within":
        card = [c + np.float32(0.5 * rel) * np.abs(c).max() for c in card]
    elif case == "close_call_swap":
        # the CPU's top two within the margin: the card may rank them the other way
        top, second = np.argsort(cpu[0])[-1], np.argsort(cpu[0])[-2]
        cpu[0][second] = cpu[0][top] - np.float32(0.25 * rel) * np.abs(cpu[0]).max()
        card[0] = cpu[0].copy()
        card[0][second], card[0][top] = cpu[0][top], cpu[0][second]
    elif case == "drift":
        card[1] = card[1] + np.float32(2 * rel) * np.abs(card[1]).max()
    elif case in ("top1_flip", "far_swap"):
        # a class far below the top pushed above it: beyond the tolerance, or
        # (far_swap) within it but past a clear lead
        order = np.argsort(cpu[2])
        top = order[-1]
        lead = cpu[2][top] - cpu[2][order[-2]]
        scale = np.abs(cpu[2]).max()
        if case == "far_swap":
            cpu[2][order[-2]] = cpu[2][top] - np.float32(3 * rel) * scale
            card[2] = cpu[2].copy()
            card[2][order[-2]] = cpu[2][top] + np.float32(0.1 * rel) * scale
        else:
            card[2][order[0]] = cpu[2][top] + lead + np.float32(rel) * scale
    elif case == "frame_order":
        card = card[1:] + card[:1]
    if ok:
        worst, close = smoke.vit_cpu_check(np, card, cpu, rel)
        assert worst <= rel and close == (1 if case == "close_call_swap" else 0)
    else:
        with pytest.raises(SystemExit):
            smoke.vit_cpu_check(np, card, cpu, rel)


@pytest.mark.parametrize("case, ok", [
    ("exact", True), ("one_bit", False), ("nan", False), ("short", False), ("dtoh", False),
    ("recapture", False)])
def test_decode_checks(smoke, case, ok):
    got = _logits(2, n=6, classes=16)
    eager = [g.copy() for g in got]
    stats, dtoh = {"captures": 1, "replays": 6}, 0
    if case == "one_bit":
        got[3] = got[3].copy()
        got[3].view(np.uint32)[5] ^= 1
    elif case == "nan":
        got[4] = np.full(16, np.nan, np.float32)
        eager[4] = got[4].copy()
    elif case == "short":
        got = got[:5]
    elif case == "dtoh":
        dtoh = 1  # the cache read back to the host
    elif case == "recapture":
        stats["captures"] = 2
    args = (np, stats, 6, 0, dtoh, got, eager)
    if ok:
        smoke.decode_checks(*args)
    else:
        with pytest.raises(SystemExit):
            smoke.decode_checks(*args)


@pytest.mark.parametrize("case, ok", [
    ("exact", True), ("eager_within", True), ("bit_apart", False), ("eager_far", False),
    ("swapped_streams", False), ("missing_stream", False)])
def test_staggered_check(smoke, case, ok):
    rel = 1e-5
    served = {k: _logits(10 + k, n=5, classes=16) for k in range(3)}
    alone = {k: [o.copy() for o in v] for k, v in served.items()}
    eager = {k: [o.copy() for o in v] for k, v in served.items()}
    if case == "eager_within":
        eager = {k: [o * np.float32(1 + 0.5 * rel) for o in v] for k, v in served.items()}
    elif case == "bit_apart":
        alone[1][2] = alone[1][2].copy()
        alone[1][2].view(np.uint32)[0] ^= 1
    elif case == "eager_far":
        eager[2][4] = eager[2][4] + np.float32(10 * rel) * np.abs(eager[2][4]).max()
    elif case == "swapped_streams":
        served[0], served[1] = served[1], served[0]  # a slot's state leaked into another
    elif case == "missing_stream":
        del served[2]
    if ok:
        assert smoke.staggered_check(np, served, alone, eager, rel) <= rel
    else:
        with pytest.raises(SystemExit):
            smoke.staggered_check(np, served, alone, eager, rel)


def test_transformer_constants_are_the_bench_cells(smoke):
    """Config 4c/4d's cell is bench.py's DECODE_CELL, the engine's capacity
    and steps leg_config4d's; ViT-B/16 the paper's widths."""
    assert smoke.DECODE_CELL == dict(t_max=128, d_in=64, n_out=16, d_model=256, n_heads=8,
                                     n_layers=2)
    assert (smoke.ENGINE_CAPACITY, smoke.ENGINE_STEPS, smoke.DECODE_STEPS) == (8, 119, 120)
    assert smoke.DECODE_SLOTS == (92, 93)
    assert smoke.VIT_B16 == dict(num_classes=1000, patch=16, d_model=768, n_heads=12,
                                 n_layers=12)
    assert smoke.STAGGER_STREAMS > smoke.ENGINE_CAPACITY
    assert smoke.STAGGER_GAP * (smoke.ENGINE_CAPACITY - 1) < smoke.STAGGER_STEPS


# -- the lanes phase ------------------------------------------------------------

def _streams(rng, n=3, rounds=4):
    return {i: [rng.standard_normal(10).astype(np.float32) for _ in range(rounds)]
            for i in range(n)}


@pytest.mark.parametrize("case", ["equal", "short_run", "bit_apart", "swapped_rows"])
def test_rounds_matched(smoke, case):
    """Each lane mode's rounds against thread mode's: equal rows count, a
    round a mode lacks is skipped, a row a bit apart or two streams'
    rows swapped fail."""
    rng = np.random.default_rng(4)
    base = _streams(rng)
    lane = {i: [r.copy() for r in rows] for i, rows in base.items()}
    runs = {"0": base, "1": lane, "auto": {i: list(rows) for i, rows in base.items()}}
    if case == "short_run":
        runs["auto"] = {i: rows[:3] for i, rows in base.items()}
        assert smoke.rounds_matched(np, runs, 4) == {"1": 4, "auto": 3}
        return
    if case == "equal":
        assert smoke.rounds_matched(np, runs, 4) == {"1": 4, "auto": 4}
        return
    if case == "bit_apart":
        lane[2][1].view(np.uint32)[5] ^= 1
    else:
        lane[0][3], lane[1][3] = lane[1][3], lane[0][3]
    with pytest.raises(SystemExit):
        smoke.rounds_matched(np, runs, 4)


@pytest.mark.parametrize("parked_s,ok", [(0.0, True), (0.004, True), (0.1, True),
                                         (0.2, False)])
def test_lane_ring_check(smoke, parked_s, ok):
    """A lane parked beside ready work for longer than two polls (the
    steal or the arm's wakeup failed) fails; shorter stretches pass."""
    ring = dict(samples=400, parked_with_work=3, longest_parked_with_work_s=parked_s,
                max_ready=2)
    if ok:
        smoke.lane_ring_check(ring, "auto")
    else:
        with pytest.raises(SystemExit):
            smoke.lane_ring_check(ring, "auto")


def test_take_launches_counts_the_path_not_the_comparison(smoke):
    class Wrapper:
        def __init__(self, name):
            self.__name__, self.launches = name, 0

    class Kernels:
        KERNELS = (Wrapper("fused_arith"), Wrapper("int8_matmul"))

        @classmethod
        def reset_launches(cls):
            for k in cls.KERNELS:
                k.launches = 0

    total = {}
    Kernels.KERNELS[0].launches, Kernels.KERNELS[1].launches = 4, 4
    snapshot = {k.__name__: k.launches for k in Kernels.KERNELS}
    Kernels.KERNELS[0].launches += 24  # eager forwards held against the replays
    smoke.take_launches(Kernels, total, snapshot)
    smoke.take_launches(Kernels, total)
    Kernels.KERNELS[1].launches = 5
    smoke.take_launches(Kernels, total)
    assert total == {"fused_arith": 4, "int8_matmul": 9}
    assert all(k.launches == 0 for k in Kernels.KERNELS)


def test_counter_sum_selects_by_labels(smoke):
    from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    c = reg.counter("nnstpu_lane_steals_total", "steals", labelnames=("pipeline", "lane"))
    c.inc(3, pipeline="a", lane="0")
    c.inc(2, pipeline="a", lane="1")
    c.inc(7, pipeline="b", lane="0")
    assert smoke.counter_sum(reg, "nnstpu_lane_steals_total", pipeline="a") == 5
    assert smoke.counter_sum(reg, "nnstpu_lane_steals_total", lane="0") == 10
    assert smoke.counter_sum(reg, "nnstpu_lane_steals_total") == 12
    assert smoke.counter_sum(reg, "nnstpu_nothing_total", pipeline="a") == 0.0


def test_watchdog_constants_leave_room_for_the_verdicts(smoke):
    """The wedged queue holds the whole stream (its source never blocks, so
    the only verdict is the queue's); the device sleep outlasts the
    deadline by more than a tick; the stall window spans several ticks."""
    assert smoke.WD_WEDGE_QUEUE > smoke.RECOVERY_FRAMES
    assert smoke.WD_WEDGE_AFTER < smoke.RECOVERY_FRAMES
    assert smoke.WD_WEDGE_MS / 1e3 > smoke.WD_STALL_S + 2 * smoke.WD_INTERVAL_S
    assert smoke.WD_SLEEP_S > smoke.WD_DEADLINE_S + 2 * smoke.WD_INTERVAL_S
    assert smoke.WD_STALL_S >= 4 * smoke.WD_INTERVAL_S
    assert smoke.LANE_MODES == ("0", "1", "auto")


# -- the query phase ---------------------------------------------------------------

def test_query_constants_fit_the_cells(smoke):
    """Path (c) fills config 4d's engine, a prompt and its steps fit the
    cache, the migration happens mid-stream; path (d)'s faults name the
    wire's send sites."""
    assert smoke.QUERY_STREAMS == smoke.ENGINE_CAPACITY
    assert smoke.PREFILL_TOKENS + smoke.QUERY_STEPS < smoke.DECODE_CELL["t_max"]
    assert 0 < smoke.QUERY_MIGRATE_AT < smoke.QUERY_STEPS
    assert smoke.QUERY_BATCH == smoke.QUERY_CLIENTS == 4
    assert smoke.QUERY_OFFERED <= smoke.QUERY_FRAMES
    assert smoke.QUERY_FAULT_FRAMES <= smoke.QUERY_FRAMES
    assert {f.split(";")[1].split("@")[0] for f in smoke.QUERY_FAULTS} == {
        "socket_drop", "truncate", "corrupt"}


@pytest.mark.parametrize("n,want", [(1, 1), (3, 4), (4, 4)])
def test_bucket_pad_repeats_the_last_row(smoke, n, want):
    import torch

    x = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2)
    y = smoke.bucket_pad(torch, x, 4)
    assert y.shape == (want, 2) and torch.equal(y[:n], x)
    assert all(torch.equal(r, x[-1]) for r in y[n:])


@pytest.mark.parametrize("case,bad", [("equal", 0), ("bit_apart", 1), ("swapped", 1),
                                      ("missing_chunk", 1)])
def test_group_mismatches(smoke, case, bad):
    """A coalesced group's replies against the in-process batched filter's
    rows for the same chunk: a bit apart, two clients' rows swapped, or a
    chunk the in-process run lacks counts as a mismatch."""
    import torch

    rng = np.random.default_rng(5)
    want = [torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)) for _ in range(2)]
    groups = [([None] * 3, [w[i:i + 1].clone() for i in range(3)]) for w in want]
    if case == "bit_apart":
        groups[1][1][2].view(torch.int32)[0, 1] ^= 1
    elif case == "swapped":
        outs = groups[0][1]
        outs[0], outs[1] = outs[1], outs[0]
    elif case == "missing_chunk":
        want = want[:1]
    assert smoke.group_mismatches(torch, groups, want) == bad


@pytest.mark.parametrize("case,ok", [("ok", True), ("untyped", False), ("lost", False),
                                     ("none_shed", False), ("server_count", False),
                                     ("differ", False)])
def test_admission_check(smoke, case, ok):
    kw = dict(offered=64, delivered=20, shed=44, server_shed=44, untyped=[], differ=0)
    kw.update({"untyped": dict(untyped=["RuntimeError('x')"]), "lost": dict(delivered=19),
               "none_shed": dict(delivered=64, shed=0, server_shed=0),
               "server_count": dict(server_shed=43), "differ": dict(differ=1),
               "ok": {}}[case])
    if ok:
        smoke.admission_check(**kw)
    else:
        with pytest.raises(SystemExit):
            smoke.admission_check(**kw)


@pytest.mark.parametrize("spec,injected,differ,untyped,ok", [
    ("seed=3;socket_drop@server:every=5", 6, 0, [], True),
    ("seed=3;socket_drop@server:every=5", 6, 1, [], False),
    ("seed=3;truncate@client:every=6", 0, 0, [], False),
    ("seed=3;truncate@client:every=6", 5, 0, ["ValueError()"], False),
    ("seed=3;corrupt@client:every=7", 4, 3, [], True),
    ("seed=3;corrupt@client:every=7", 4, 5, [], False),
])
def test_wire_fault_check(smoke, spec, injected, differ, untyped, ok):
    """Drops and torn frames must heal bit for bit; a corrupted payload
    byte (no checksum on NNSQ) may change at most the injected frames."""
    if ok:
        smoke.wire_fault_check(spec, injected, differ, untyped)
    else:
        with pytest.raises(SystemExit):
            smoke.wire_fault_check(spec, injected, differ, untyped)


# -- the stream phase ------------------------------------------------------------

def _rate_element(stamps, framerate):
    """What the port's tensor_rate sends for frames stamped (pts, duration),
    each carrying its index: [(pts, index)], drop, dup."""
    import torch

    import nnstreamer_tpu_torch as tnns
    from nnstreamer_tpu_torch.buffer import Frame

    p = tnns.Pipeline()
    src = p.add(tnns.make("datasrc", data=[Frame(tensors=(torch.tensor([i]),), pts=pts,
                                                 duration=d) for i, (pts, d) in enumerate(stamps)]))
    rate = p.add(tnns.make("tensor_rate", framerate=framerate))
    sink = p.add(tnns.make("tensor_sink", collect=True))
    p.link_chain(src, rate, sink)
    p.run(timeout=60)
    return [(f.pts, int(f.tensor(0)[0])) for f in sink.frames], rate.drop, rate.dup


@pytest.mark.parametrize("seed", range(8))
def test_rate_model_is_the_element(smoke, seed):
    """The host model of tensor_rate, on the stream phase's stamps (a 30/1
    source, about half the frames through the gate), against the element."""
    rng = np.random.default_rng(seed)
    dur = 1_000_000_000 // 30
    kept = [i for i in range(smoke.STREAM_FRAMES) if rng.random() < 0.5]
    stamps = [(i * dur, dur) for i in kept]
    num, den = (int(v) for v in smoke.STREAM_RATE.split("/"))
    period = int(1e9 * den / num)
    slots, drop, dup = smoke.rate_model(stamps, period)
    got, gdrop, gdup = _rate_element(stamps, smoke.STREAM_RATE)
    assert [(s * period, j) for s, j in slots] == got
    assert (drop, dup) == (gdrop, gdup) and drop > 0 and dup > 0


@pytest.mark.parametrize("stamps,framerate,want", [
    ([(i * 33_333_333, 33_333_333) for i in range(10)], "10/1", [0, 2, 5, 8]),
    ([(i * 100_000_000, 100_000_000) for i in range(4)], "30/1",
     [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]),
    ([(0, 33_000_000), (40_000_000, 33_000_000), (210_000_000, 33_000_000)], "10/1", [0, 1, 2]),
    ([], "10/1", []),
])
def test_rate_model_on_the_references_cases(smoke, stamps, framerate, want):
    """The JAX package's tensor_rate cases (tests/test_crop_rate.py):
    down-sample, up-sample with the end's fill, a gap repeating the frame
    received last."""
    num, den = (int(v) for v in framerate.split("/"))
    slots, _, _ = smoke.rate_model(stamps, int(1e9 * den / num))
    assert [j for _, j in slots] == want


@pytest.mark.parametrize("threshold,want", [(0.5, [False, True, False]), (0.9, [False] * 3),
                                            (0.1, [False, True, True])])
def test_gate_model(smoke, threshold, want):
    assert smoke.gate_model([0.1, 0.7, 0.5], threshold) == want


@pytest.mark.parametrize("got,ok", [((34, 34), True), ((33, 35), False), ((34, 34, 1), False)])
def test_stream_counts_check(smoke, got, ok):
    if ok:
        smoke.stream_counts_check(got, (34, 34), "gate")
    else:
        with pytest.raises(SystemExit):
            smoke.stream_counts_check(got, (34, 34), "gate")


@pytest.mark.parametrize("case,ok", [("equal", True), ("one_bit", False), ("short", False)])
def test_checksum_check(smoke, case, ok):
    """A tap's checksums against the byte sums of the frames it should see:
    the port's tensor_debug on those frames passes; one byte changed or a
    frame missing fails."""
    import torch

    from nnstreamer_tpu_torch.elements.debug import byte_sum

    rng = np.random.default_rng(4)
    frames = [torch.from_numpy(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
              for _ in range(4)]
    sums = [byte_sum(f) for f in frames]
    want = [smoke.byte_sum(torch, f) for f in frames]
    if case == "one_bit":
        frames[2].view(-1)[5] ^= 1
        want = [smoke.byte_sum(torch, f) for f in frames]
    elif case == "short":
        sums = sums[:3]
    if ok:
        smoke.checksum_check(sums, want, "tap")
    else:
        with pytest.raises(SystemExit):
            smoke.checksum_check(sums, want, "tap")


def test_class_masks_are_sparse_and_seeded(smoke):
    a = smoke.class_masks(np, np.random.default_rng(19), 4, 128, 21, 0.04)
    b = smoke.class_masks(np, np.random.default_rng(19), 4, 128, 21, 0.04)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for m in a:
        share = np.count_nonzero(m) / m.size
        assert m.dtype == np.uint8 and 0.04 <= share < 0.08 and m.max() < 21


def test_pb_messages_splits_on_the_prefixes(smoke):
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.interop import encode_frame

    import torch

    msgs = [encode_frame(Frame.of(torch.full((i + 1,), i, dtype=torch.uint8), pts=i))
            for i in range(5)]
    data = b"".join(len(m).to_bytes(8, "little") + m for m in msgs)
    spans = smoke.pb_messages(data)
    assert [data[a:b] for a, b in spans] == msgs
    assert spans[-1][1] == len(data) and smoke.pb_messages(b"") == []


# -- the mesh phase ----------------------------------------------------------------
#
# A sharded dispatch replays, per round, segment 0 of each of 4 shards, then
# segment 1 of each: config 5's int8 head under dp:4 puts the normalize in
# segment 0 and the int8 head in segment 1 (the batch's scale is reduced
# between them).

SHARDS = 4
SEGMENTS = [("fused_arith",), ("int8_matmul",)]
SEG_GRAPH = (200, 40)   # device records of a shard's segment 0 and segment 1


def _sharded(rounds=3):
    per = []
    for _ in range(rounds):
        per += [({"fused_arith": 1}, SEG_GRAPH[0]) for _ in range(SHARDS)]
        per += [({"int8_matmul": 1}, SEG_GRAPH[1]) for _ in range(SHARDS)]
    return per


def test_shard_launch_check_counts_a_record_a_shard(smoke):
    rounds, counts, lost = smoke.shard_launch_check(_trace(_sharded()), SHARDS, SEGMENTS)
    assert (rounds, counts, lost) == (3, {"fused_arith": 12, "int8_matmul": 12}, 0)


def test_shard_launch_check_allows_a_lost_record(smoke):
    per = _sharded()
    per[9] = ({}, SEG_GRAPH[0] - 1)  # round 1, shard 1's segment 0 lost a record
    rounds, counts, lost = smoke.shard_launch_check(_trace(per), SHARDS, SEGMENTS)
    assert rounds == 3 and lost == 1 and counts["fused_arith"] == 11


@pytest.mark.parametrize("case", ["kernel_in_the_wrong_segment", "missing_no_loss",
                                  "twice_a_shard", "not_whole_rounds", "one_graph_a_round"])
def test_shard_launch_faults_fail(smoke, case):
    per = _sharded()
    if case == "kernel_in_the_wrong_segment":   # the head ran before the reduction
        per[0] = ({"fused_arith": 1, "int8_matmul": 1}, SEG_GRAPH[0] + 1)
    elif case == "missing_no_loss":
        per[5] = ({}, SEG_GRAPH[1])
    elif case == "twice_a_shard":
        per[2] = ({"fused_arith": 2}, SEG_GRAPH[0] + 1)
    elif case == "not_whole_rounds":
        per = per[:-1]
    elif case == "one_graph_a_round":           # the batch in one graph: no sharding
        per = [({"fused_arith": 1, "int8_matmul": 1}, 240) for _ in range(3)]
    with pytest.raises(SystemExit):
        smoke.shard_launch_check(_trace(per), SHARDS, SEGMENTS)


@pytest.mark.parametrize("shift, ok", [(0.0, True), (0.01, True), (0.2, False)])
def test_rows_check(smoke, shift, ok):
    rng = np.random.default_rng(4)
    want = [rng.standard_normal(16).astype(np.float32) for _ in range(6)]
    got = [w + np.float32(shift) * np.abs(want[0]).max() * (i == 3) for i, w in enumerate(want)]
    if ok:
        assert smoke.rows_check(np, got, want, 1 / 32) <= 1 / 32
    else:
        with pytest.raises(SystemExit):
            smoke.rows_check(np, got, want, 1 / 32)


def test_rows_check_fails_an_argmax_flip(smoke):
    want = [np.array([1.0, 0.999, 0.0], np.float32)]
    got = [np.array([0.999, 1.0, 0.0], np.float32)]
    with pytest.raises(SystemExit):
        smoke.rows_check(np, got, want, 1 / 32)


@pytest.mark.parametrize("launches, ok", [
    ({"fused_arith": 16, "int8_matmul": 16, "pallas_nms_keep": 0}, True),
    ({"fused_arith": 4, "int8_matmul": 4, "pallas_nms_keep": 0}, False),   # one shard only
    ({"fused_arith": 16, "int8_matmul": 17, "pallas_nms_keep": 0}, False),  # an eager launch
])
def test_sharded_capture_check(smoke, launches, ok):
    stats = dict(captures=1, replays=16, warmup_calls=3)
    if ok:
        smoke.sharded_capture_check(stats, 16, launches, ("fused_arith", "int8_matmul"), 4)
    else:
        with pytest.raises(SystemExit):
            smoke.sharded_capture_check(stats, 16, launches, ("fused_arith", "int8_matmul"), 4)


def test_mesh_legs_are_the_published_widths(smoke):
    """The five legs at the widths the phase claims: ViT-B/16's 196 tokens and
    12 heads divide over the shards, Switch-Base-8's experts too, GPipe's
    12 layers into the stages and its batch into the microbatches, config
    5's streams into the shards; the contrast differs between shards."""
    legs = smoke.parallel_legs()
    assert sorted(legs) == ["a", "b", "c", "d", "e"]
    n = smoke.PAR_SHARDS
    assert (224 // 16) ** 2 % n == 0 and smoke.VIT_B16["n_heads"] % n == 0
    sb = smoke.SWITCH_BASE
    assert (sb["d_model"], sb["n_heads"], sb["d_ff"], sb["experts"], sb["n_layers"]) == \
        (768, 12, 3072, 8, 12) and sb["experts"] % n == 0
    assert smoke.MOE_WINDOW == (512, 768)
    c = smoke.PP_CFG
    assert (c["d_model"], c["n_heads"], c["n_layers"], c["seq_len"]) == (768, 12, 12, 196)
    assert c["n_layers"] % n == 0 and smoke.PP_BATCH % smoke.PP_MICRO == 0
    assert smoke.MESH_STREAMS % n == 0 and len(smoke.MESH_CONTRAST) == smoke.MESH_STREAMS
    rows = smoke.MESH_STREAMS // n  # a shard's streams: consecutive rows of the batch
    shard_maxima = [max(smoke.MESH_CONTRAST[k * rows:(k + 1) * rows]) for k in range(n)]
    assert len(set(shard_maxima)) > 1


def test_mesh_frames_follow_the_contrast(smoke):
    import torch

    from nnstreamer_tpu_torch.buffer import Frame

    frames = smoke.mesh_frames(np, torch, Frame, np.random.default_rng(0), 8, 2)
    assert len(frames) == 8 and all(len(f) == 2 for f in frames)
    for i, stream in enumerate(frames):
        x = stream[0].tensor(0).numpy().astype(int)
        assert x.dtype.kind == "i" and np.abs(x - 127).max() <= smoke.MESH_CONTRAST[i]


def _chain(shift=0, serve_dur=300, dev_at=40, parent_ok=True):
    """One trace's records as ``spans_by_trace`` gives them: the client's
    rtt and the router's route here, the worker's serve and device span
    (``shift`` ns off the route by a clock error)."""
    rtt = ("X", 1000, 1000, "c", "nnsq_rtt", "query", 7, 1, 0, None, "chip_smoke")
    route = ("X", 1100, 800, "r", "nnsq_route", "fleet", 7, 2, 1, None, "chip_smoke")
    serve = ("X", 1200 + shift, serve_dur, "w", "nnsq_serve", "query", 7, 3,
             2 if parent_ok else 9, None, "w0")
    dev = ("X", 1200 + shift + dev_at, 900, "d", "device_exec", "device", 7, 4, 3, None, "w0")
    return {7: [rtt, route, serve, dev]}


@pytest.mark.parametrize("kw,rtt_ns,ok", [
    (dict(), 0, True),
    (dict(shift=-150_000), 400_000, True),     # inside half the probe's round trip
    (dict(shift=-300_000), 400_000, False),    # past it: the clocks are not aligned
    (dict(serve_dur=900_000), 100_000, False),  # the serve outlasts the route
    (dict(dev_at=500), 0, False),              # the device span starts after the serve
    (dict(parent_ok=False), 0, False),         # the serve is not the route's child
])
def test_fleet_chain_needs_parents_and_aligned_clocks(smoke, kw, rtt_ns, ok):
    assert (smoke.fleet_chain(_chain(**kw), {"w0": rtt_ns}) == [7]) is ok


_CAPTURE = {"fused_arith": 4, "int8_matmul": 4, "pallas_nms_keep": 0}
_NONE = dict.fromkeys(_CAPTURE, 0)


@pytest.mark.parametrize("seen,n_bad", [
    ([("fleet-a-w1", "n1", _CAPTURE, "cuda:0"), ("fleet-b-w1", "n2", _NONE, "cuda:0")], 0),
    # a stateless worker joined before its capture
    ([("fleet-a-w1", "n1", _NONE, "cuda:0")], 1),
    # or served on another route: more wrapper calls than its capture's
    ([("fleet-c-w1", "n1", dict(_CAPTURE, fused_arith=5), "cuda:0")], 1),
    # a decode worker that launched a path kernel
    ([("fleet-b-w2", "n1", _CAPTURE, "cuda:0")], 1),
    # a join whose /stats.json was not read
    ([("fleet-a-w2", "n1", "URLError('refused')", None)], 1),
])
def test_fleet_join_check_holds_each_incarnation_to_its_capture(smoke, seen, n_bad):
    assert smoke.FLEET_CAPTURE_CALLS == _CAPTURE
    assert len(smoke.fleet_join_check(seen)) == n_bad


def _served(captures=1, replays=9, invokes=9, replies=9):
    return {"query": {"graphs": {"captures": captures, "replays": replays},
                      "invokes": invokes, "replies": replies}}


@pytest.mark.parametrize("st,routed,n_bad", [
    (_served(), 9, 0),
    (_served(), None, 0),
    (_served(replays=0), 9, 1),          # served eagerly: no replay
    (_served(captures=2), 9, 1),         # captured again after its warmup
    (_served(), 8, 1),                   # the router counts another number
    (_served(captures=0, replays=0, replies=8), 9, 3),
])
def test_fleet_replay_check_holds_replays_to_replies(smoke, st, routed, n_bad):
    assert len(smoke.fleet_replay_check("w", st, routed=routed)) == n_bad


# -- placement, the native queue and the soak (slice 22) ----------------------

_PART_REF = [3, 1, 4, 1, 5]
_CLIENT = {"fused_arith": 5, "int8_matmul": 0, "pallas_nms_keep": 0}
_WORKER = {"fused_arith": 0, "int8_matmul": 4, "pallas_nms_keep": 0}


@pytest.mark.parametrize("case,n_bad", [
    (dict(), 0),
    (dict(got=[3, 1, 4, 1, 6]), 1),                           # a label moved
    (dict(delivered=4), 1),                                   # a frame lost on the edge
    (dict(client=dict(_CLIENT, fused_arith=4)), 1),           # a frame not normalized here
    (dict(client=dict(_CLIENT, int8_matmul=1)), 1),           # the head ran on this side
    (dict(worker=dict(_WORKER, int8_matmul=5)), 1),           # the worker ran eagerly
    (dict(worker=dict(_WORKER, fused_arith=4)), 1),           # the normalize in the worker
    (dict(got=[0] * 5, delivered=3, worker=_CLIENT), 3),
])
def test_partition_check(smoke, case, n_bad):
    kw = dict(ref=_PART_REF, got=list(_PART_REF), offered=5, delivered=5, client=_CLIENT,
              worker=_WORKER)
    kw.update(case)
    assert len(smoke.partition_check(**kw)) == n_bad


def test_labels_of_takes_the_first_of_equal_maxima(smoke):
    assert smoke.labels_of(np, [np.array([0.0, 2.0, 2.0]), np.array([[5.0], [1.0]])]) == [1, 0]


def test_part_desc_cuts_at_the_filter(smoke):
    from nnstreamer_tpu_torch.graph.parse import linear_chain, split_launch

    desc = smoke.part_desc("/tmp/m.npz", n=8)
    chain = linear_chain(desc)
    assert chain[smoke.PART_CUT][0] == "tensor_filter"
    assert [e for e, _ in chain[:smoke.PART_CUT]] == [
        "videotestsrc", "tensor_converter", "tensor_transform", "tensor_upload", "queue"]
    client, server = split_launch(desc, smoke.PART_CUT, {"port": "1"})
    assert "tensor_transform" in client and "tensor_transform" not in server
    assert server.startswith("tensor_filter") and "num-buffers=8" in client


def test_force_cut_takes_the_plans_own_score(smoke):
    from nnstreamer_tpu_torch.partition import plan_partition

    desc = smoke.part_desc("/tmp/m.npz", n=8)
    plan = plan_partition(desc, pipeline="p", addr="a", edge="e",
                          cost_model={"schema": 1, "stages": {}},
                          wire_health={"put_150k_ms": 0.5, "dispatch_ms": 0.2})
    assert plan.cut is None
    forced = smoke.force_cut(plan, smoke.PART_CUT)
    assert forced.cut == smoke.PART_CUT and forced.split
    assert forced.chosen == plan.score_for(smoke.PART_CUT)
    assert forced.fingerprint == plan.fingerprint and plan.cut is None


@pytest.mark.parametrize("mode,want", [
    ("downstream", ([0, 8, 9, 10, 11], 7)),
    ("upstream", ([0, 1, 2, 3, 4], 7)),
    ("no", (list(range(12)), 0)),
])
def test_leak_expect(smoke, mode, want):
    assert (smoke.LEAK_FRAMES, smoke.LEAK_CAPACITY) == (12, 4)
    assert smoke.leak_expect(mode) == want


def _soak_line(**kw):
    res = dict(iterations=40, failures=0, failed_seeds=[], templates={"run_tee": 40},
               device="cuda", lockdep=dict(installed=True, sites=71, edges=13, cycles=0,
                                           blocked=0, blocking_calls=0, suppressed=0))
    res.update(kw)
    return "soak_campaign: device cuda\n[0] run_tee seed=22 OK\n" + json.dumps(res) + "\n"


@pytest.mark.parametrize("rc,stdout,n_bad", [
    (0, _soak_line(), 0),
    (1, _soak_line(failures=1, failed_seeds=[23]), 2),
    (1, _soak_line(lockdep=dict(installed=True, cycles=2)), 2),
    (0, _soak_line(lockdep=None), 1),                     # run without lockdep
    (0, _soak_line(iterations=0), 1),
    (137, "soak_campaign: device cuda\n[0] run_tee seed=22 OK\n", 1),  # killed, no result
    (0, "", 1),
])
def test_soak_verdict(smoke, rc, stdout, n_bad):
    res, bad = smoke.soak_verdict(rc, stdout)
    assert len(bad) == n_bad, bad
    assert (res is None) == (n_bad == 1 and not stdout.rstrip().endswith("}"))


def test_soak_verdict_reads_the_campaigns_own_line(smoke, monkeypatch):
    """The line the campaign prints last is what the verdict reads."""
    import io

    from nnstreamer_tpu_torch.tools import soak_campaign

    monkeypatch.setattr(soak_campaign, "DEVICE", "cpu")
    out = io.StringIO()
    res = soak_campaign.campaign(0.0, 5, "cpu", out=out)
    res.update(device="cpu", lockdep=soak_campaign.lockdep_counts())
    got, bad = smoke.soak_verdict(0, out.getvalue() + json.dumps(res) + "\n")
    from nnstreamer_tpu_torch.analysis import lockdep

    assert got["iterations"] == 1
    assert bad == ([] if lockdep.installed() else ["lockdep was not installed"])

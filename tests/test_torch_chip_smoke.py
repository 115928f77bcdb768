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
phase's checks get backend stats and copy counts.
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


def test_batch_strings_name_the_path(smoke):
    desc = smoke.batch_desc(4, "m.npz", "build")
    assert desc.count("datasrc name=cam") == 4 and desc.count("tensor_sink") == 4
    assert "tensor_batch" in desc and "tensor_unbatch" in desc and "batch=4" in desc
    assert "acceleration=pallas" in desc and "tensor_upload name=u" in desc
    d = smoke.dyn_desc()
    assert f"tensor_dynbatch name=dyn max_batch={smoke.DYN_MAX_BATCH}" in d
    assert d.index("tensor_dynbatch") < d.index("tensor_transform") < d.index("tensor_filter")

#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port runs on the GPU.

Run from the root of a checkout, with one NVIDIA Hopper GPU and the CUDA
toolkit:

    python3 chip_smoke.py

In order, it
1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the port from ``nnstreamer_tpu_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the build time
   and each kernel's ``ptxas -v`` registers, stack frame and spills
   (``fused_arith`` summed over its instantiations: it must have no stack
   frame and no spills);
3. kernel phase: runs each kernel on the card at its path's shapes (and a
   few others) against its plain PyTorch version on the same inputs:
   ``fused_arith`` and ``nms_keep`` must be bitwise equal (a NaN equal to
   any NaN), ``int8_matmul`` exact in its int32 accumulator and within 1
   ulp in float32; ``fused_arith``'s cases add a 4K frame, inputs 1 and
   4 bytes past a 16-byte boundary, a float16 chain, a uint32 chain that
   wraps, float32 NaN and +-inf through typecasts to int8 and uint16, and
   two chains with 32 output bytes a vector (int16 -> float32, uint8 ->
   uint16).
   Then it times kernel, plain version and, where one exists, the one
   PyTorch call that computes the same function (a yardstick only; the
   port never calls it); each kernel at its smallest case as its launch
   floor; ``fused_arith`` also at the 4K frame and, beside it,
   ``x.to(torch.float32)`` on the same frames (the same bytes and one
   conversion, a yardstick for the chain);
4. image-labeling phase (slice 1): builds MobileNet-v2 1.0 (224x224x3 uint8
   frames, 1001 classes, bf16, int8 classifier head, random weights from a
   fixed seed) and runs 64 ``videotestsrc`` frames through the pipeline on
   the card; ``fused_arith`` and ``int8_matmul`` must launch once per frame,
   and the labels must equal those of the same model run on the card with
   the kernels' plain versions;
5. object-detection phase (slice 2): builds SSD-MobileNet-v2 1.0 (300x300x3
   uint8 frames, 1917 anchors, 91 labels, bf16, random weights from a fixed
   seed) and runs 64 frames through the tflite-ssd pipeline with
   whole-segment compilation on: the converter and the decoder must fold
   into the filter, ``fused_arith`` and ``nms_keep`` must
   launch once per frame, and the detections must equal those of the same
   frames decoded on the host (boxes and classes exactly, probs within
   ``PROB_ATOL``); then the fused-decode variant (``fused_decode=100``,
   ``fused-ssd`` decoder) with segments on and off must agree bitwise;
6. prints one JSON line describing every kernel, and last one JSON line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Without a CUDA GPU, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

FRAMES = 64
WARMUP_FRAMES = 4
PROFILED = 16
IMAGE = 224
CLASSES = 1001
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
# Slice 2: SSD-MobileNet-v2 at full width, 91 labels (COCO's label map).
SSD_IMAGE = 300
SSD_LABELS = 91
SSD_TOPK = 100          # fused_decode of the fused-ssd variant
FUSED_FRAMES = 8
# 1280 and 1281 sit on either side of the kernel's bit-branch limit
# (ops/nms.py BITS_MAX_K), 8192 is its largest K.
NMS_KS = (1, 7, 100, 128, 129, 1000, 1280, 1281, 4096, 8192)
NMS_TIMED_K = 100       # the tflite-ssd lowering's PRE_NMS_TOP_K
# CUDA's expf and numpy's exp differ by ulps: a detection's prob from the
# card may differ from the host decode's by a few ulps of 1.0.
PROB_ATOL = 1e-5
FRAME_4K = (2160, 3840, 3)  # 124.4 MB in and out: more than the 50 MB L2
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "int8": 1979e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events.  When the host takes longer to dispatch a call than the card
    to run it, this is the host's dispatch rate, not the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_cuda(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler (CUPTI); return the
    card's summed kernel and copy time in ms and the number of device
    activities, or (None, 0) when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # Device-side events only: a CPU op's own time on the device repeats its
    # kernels' time.
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.device_time_total for e in device)
    return (total_us / 1e3 if total_us > 0 else None), len(device)


def device_ms(fn, iters: int = 100, warmup: int = 20, activities: int = 0):
    """Device time per call of ``fn`` (all its kernels and copies) from a
    profiler trace, L2 warm; falls back to CUDA events around back-to-back
    calls when the profiler records no device time.  Returns (ms, timer).
    With ``activities`` (the device activities one call makes), a trace
    that holds another count has lost records and is taken again, up to
    five times; the fifth is taken if it holds at least 90% of the records,
    as the mean of those it holds, else CUDA events time the calls."""
    for _ in range(warmup):
        fn()
    for _ in range(5):
        total, count = profile_cuda(fn, iters)
        if total is None:
            break
        if not activities or count == activities * iters:
            return total / iters, "cupti"
    if total is not None and activities * iters * 0.9 <= count <= activities * iters:
        return total / count * activities, "cupti"
    return call_ms(fn, iters, warmup=0), "events"


def bound_ms(nbytes: int, ops: int, op_type: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bitwise_equal(torch, a, b) -> bool:
    """Equal bit for bit, except that any NaN equals any NaN (the plain
    version's PyTorch kernels may give a NaN another payload)."""
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(na, nb) and torch.equal(a[~na].view(bits), b[~nb].view(bits))


def max_ulp(a, b) -> int:
    """Largest distance in float32 ulps between two finite float32 tensors."""
    import torch

    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)  # sign-magnitude → ordered
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def kernel_phase(torch, np, K, bind, jax_pkg):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = {}

    # -- fused_arith: bitwise against its plain version ---------------------
    def ints(dtype, lo, hi):
        return lambda shape: rng.integers(lo, hi, shape).astype(dtype)

    def floats(dtype):
        def make(shape):
            x = (rng.standard_normal(shape) * 300).astype(dtype)
            x.flat[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e9 if dtype == np.float32 else 6e4]
            return x
        return make

    u8 = ints(np.uint8, 0, 256)
    cases = [
        ((IMAGE, IMAGE, 3), u8, NORMALIZE, 0),
        ((SSD_IMAGE, SSD_IMAGE, 3), u8, NORMALIZE, 0),
        (FRAME_4K, u8, NORMALIZE, 0),
        ((IMAGE, IMAGE, 3), u8, NORMALIZE, 1),  # a view one byte into its storage: all scalar
        ((IMAGE, IMAGE, 3), u8, NORMALIZE, 4),  # four bytes: 12 scalars, then vectors
        ((1,), u8, NORMALIZE, 0),
        ((127,), u8, NORMALIZE, 0),
        ((1_000_003,), u8, NORMALIZE, 0),
        ((4099,), ints(np.int32, -1000, 1000), "mul:3,sub:7,clamp:-100:100", 0),
        ((4099,), u8, "add:-128", 0),
        ((4099,), u8, "clamp:-1:1", 0),
        ((100_003,), floats(np.float16), "mul:3,add:0.1,clamp:-1000:1000.5", 0),
        ((100_003,), ints(np.uint32, 0, 2 ** 32), "mul:65537,add:4000000000", 0),  # wraps
        ((100_003,), floats(np.float32), "typecast:int8", 0),  # NaN and +-inf to int
        ((100_003,), floats(np.float32), "typecast:uint16", 0),
        # 32 output bytes a vector: staged stores of two pieces
        ((100_003,), ints(np.int16, -32768, 32768), "typecast:float32,mul:0.5", 0),
        ((100_003,), u8, "typecast:uint16,mul:300", 0),
    ]
    err = 0.0
    for shape, make, option, offset in cases:
        x = make(shape)
        dtype = x.dtype
        ops = bind(option, dtype)
        xd = torch.from_numpy(x).to(dev)
        if offset:
            view = torch.empty(x.size + offset, dtype=xd.dtype, device=dev)[offset:]
            xd = view.view(shape).copy_(xd)
            check(xd.data_ptr() % 16 != 0, "the misaligned input is 16-byte aligned")
        got = K.fused_arith(xd, ops)
        want = K.fused_arith_plain(xd, ops)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"fused_arith {option} {shape}: dtype/shape {got.dtype}{tuple(got.shape)}")
        check(bitwise_equal(torch, got, want), f"fused_arith {option} {shape} {dtype}: "
                                               "not bitwise equal to its plain version")
        finite = torch.isfinite(want) if want.dtype.is_floating_point else slice(None)
        err = max(err, float((got[finite].double() - want[finite].double()).abs().max()))
        where = f", {offset * x.itemsize} bytes past a 16-byte boundary" if offset else ""
        print(f"fused_arith {dtype.name}{shape} '{option}'{where}: bitwise equal", flush=True)

    ops = bind(NORMALIZE, np.dtype(np.uint8))
    rows = []
    # the labeling path's frame, the detection path's, then a 4K frame that
    # does not fit in L2
    for shape in ((IMAGE, IMAGE, 3), (SSD_IMAGE, SSD_IMAGE, 3), FRAME_4K):
        x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(dev)
        n = x.numel()
        t_bytes, by = bound_ms(n * 1 + n * 4, n * 2, "float32")
        row = timed(
            dict(name="fused_arith", route="cuda",
                 source="nnstreamer_tpu_torch/csrc/fused_arith.cu",
                 replaces=f"{jax_pkg}/ops/pallas_kernels.py:77", max_abs_err=err,
                 bound_ms=t_bytes, bound_by=by,
                 shape=f"{shape} uint8 -> float32, '{NORMALIZE}'"),
            kernel=lambda x=x: K.fused_arith(x, ops),
            plain=None if shape == FRAME_4K else (lambda x=x: K.fused_arith_plain(x, ops)))
        # same bytes, one conversion: a yardstick, not the chain
        row["cast_ms"] = device_ms(lambda x=x: x.to(torch.float32), activities=1)[0]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
    results["fused_arith"] = rows[0]
    keys = ("shape", "ms", "plain_ms", "cast_ms", "call_ms", "bound_ms", "bound_by",
            "share_of_bound")
    rows[0]["at_detection_shape"] = {key: rows[1][key] for key in keys}
    rows[0]["at_4k"] = {key: rows[2][key] for key in keys}
    one = torch.zeros(1, dtype=torch.uint8, device=dev)
    rows[0]["launch_floor_ms"], rows[0]["launch_floor_timer"] = device_ms(
        lambda: K.fused_arith(one, ops), activities=1)

    # -- int8_matmul: exact int32, float32 within 1 ulp ----------------------
    # M = 16 and 17 sit on either side of the split-K branch's limit
    # (ops/kernels.py SMALL_M); "misaligned" weights start one byte into
    # their storage, so data_ptr() is not 16-byte aligned.
    err = 0.0
    for m, k, n, misaligned in [
            (1, 1280, 1001, False), (3, 1280, 1001, False), (33, 64, 10, False),
            (300, 1280, 256, False), (16, 1280, 1001, False), (17, 1280, 1001, False),
            (1, 1283, 1001, False), (1, 7, 5, False), (1, 1280, 1001, True),
            (1, 1283, 1001, True), (17, 1280, 1001, True)]:
        xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
        wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
        acc = xq.astype(np.int64) @ wq.astype(np.int64)
        check(np.abs(acc).max() < 2 ** 24, "int32 check needs |acc| < 2**24")
        ops_d = [torch.from_numpy(a).to(dev) for a in (
            xq, wq, np.array(1.0, np.float32), np.ones((1, n), np.float32),
            np.zeros(n, np.float32))]
        if misaligned:
            view = torch.empty(k * n + 1, dtype=torch.int8, device=dev)[1:].view(k, n)
            view.copy_(ops_d[1])
            check(view.data_ptr() % 16 != 0, "the misaligned weight is 16-byte aligned")
            ops_d[1] = view
        branch = K.int8_matmul_geometry(m, k, n).branch
        got = K.int8_matmul(*ops_d)
        torch.cuda.synchronize()
        check(np.array_equal(got.cpu().numpy().astype(np.int64), acc),
              f"int8_matmul ({m},{k},{n}): int32 accumulator not exact")
        xs = torch.tensor(np.float32(rng.random() * 0.1 + 1e-3), device=dev)
        ws = torch.from_numpy((rng.random((1, n)) * 0.01 + 1e-4).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        ulps = 0
        for bias in (b, None):
            got = K.int8_matmul(ops_d[0], ops_d[1], xs, ws, bias)
            want = K.int8_matmul_plain(ops_d[0], ops_d[1], xs, ws, bias)
            torch.cuda.synchronize()
            ulps = max(ulps, max_ulp(got, want))
            check(ulps <= 1, f"int8_matmul ({m},{k},{n}): {ulps} ulp from its plain version")
            err = max(err, float((got - want).abs().max()))
        print(f"int8_matmul ({m},{k},{n}) {branch}{', misaligned weight' if misaligned else ''}: "
              f"int32 exact, float32 max {ulps} ulp", flush=True)

    m, k, n = 1, 1280, CLASSES
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    xs = torch.tensor(np.float32(0.01), device=dev)
    ws = torch.full((1, n), 0.001, device=dev)
    b = torch.zeros(n, device=dev)
    # torch._int_mm wants more than 16 rows and multiples of 8: pad once.
    xp = torch.zeros((32, k), dtype=torch.int8, device=dev)
    xp[:m] = xq
    wp = torch.zeros((k, -(-n // 8) * 8), dtype=torch.int8, device=dev)
    wp[:, :n] = wq
    t_bytes, by = bound_ms(m * k + k * n + 4 + 4 * n + 4 * n + 4 * m * n, 2 * m * k * n, "int8")
    results["int8_matmul"] = timed(
        dict(name="int8_matmul", route="cuda", source="nnstreamer_tpu_torch/csrc/int8_matmul.cu",
             replaces=f"{jax_pkg}/ops/pallas_kernels.py:125", max_abs_err=err,
             bound_ms=t_bytes, bound_by=by, shape=f"({m},{k})x({k},{n}) int8 -> float32"),
        kernel=lambda: K.int8_matmul(xq, wq, xs, ws, b),
        plain=lambda: K.int8_matmul_plain(xq, wq, xs, ws, b),
        library=lambda: torch._int_mm(xp, wp))
    small = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-127, 128, (1, 7)).astype(np.int8),
        rng.integers(-127, 128, (7, 5)).astype(np.int8), np.array(1.0, np.float32),
        np.ones((1, 5), np.float32), np.zeros(5, np.float32))]
    floor = device_ms(lambda: K.int8_matmul(*small), activities=1)
    results["int8_matmul"]["launch_floor_ms"], results["int8_matmul"]["launch_floor_timer"] = floor
    results["nms_keep"] = nms_kernel_phase(torch, np, jax_pkg)
    for r in results.values():
        print(f"{r['name']}: kernel {r['ms']} ms ({r['timer']}), per call {r['call_ms']} ms, "
              f"plain {r['plain_ms']} ms, bound {r['bound_ms']} ms ({r['bound_by']}), "
              f"library {r['library_ms']} ms, launch floor {r['launch_floor_ms']} ms "
              f"({r['launch_floor_timer']})",
              flush=True)
    for key in ("at_detection_shape", "at_4k"):
        r = results["fused_arith"][key]
        print(f"fused_arith {r['shape']}: kernel {r['ms']} ms, x.to(float32) {r['cast_ms']} ms, "
              f"bound {r['bound_ms']} ms, {r['share_of_bound']} of the bound", flush=True)
    return results


def nms_cases(np, rng, k):
    """(name, x, y, w, h, valid) score-ordered integer-pixel cases at K=k."""
    def ints(lo, hi):
        return rng.integers(lo, hi, k).astype(np.float32)

    x, y, w, h = ints(0, 300), ints(0, 300), ints(1, 150), ints(1, 150)
    zero_w = w.copy()
    zero_w[::2] = 0
    ones = np.ones(k, bool)
    return [
        ("random", x, y, w, h, rng.random(k) < 0.8),
        ("all-invalid", x, y, w, h, np.zeros(k, bool)),
        ("identical", np.full(k, 10, np.float32), np.full(k, 12, np.float32),
         np.full(k, 20, np.float32), np.full(k, 30, np.float32), ones),
        ("zero-area", x, y, zero_w, h, ones),
        # pixel areas above 2**24: float32 rounding decides verdicts
        ("area>2^24", ints(0, 3000), ints(0, 3000), ints(4100, 9000), ints(4100, 9000), ones),
        # NaN coordinates: every pair with a NaN is kept apart
        ("nan", np.where(rng.random(k) < 0.1, np.float32(np.nan), x), y, w,
         np.where(rng.random(k) < 0.1, np.float32(np.nan), h), ones),
    ]


def nms_pairs(np, x, y, w, h, valid):
    """Pairs the greedy pass tests on these boxes: for each row still kept
    when its turn comes, the later rows still kept then."""
    x2, y2 = x + w, y + h
    keep = valid.copy()
    pairs = 0
    for i in range(len(x)):
        if not keep[i]:
            continue
        j = np.arange(i + 1, len(x))[keep[i + 1:]]
        pairs += len(j)
        iw = np.maximum(np.float32(0), np.minimum(x2[i], x2[j]) - np.maximum(x[i], x[j]) + 1)
        ih = np.maximum(np.float32(0), np.minimum(y2[i], y2[j]) - np.maximum(y[i], y[j]) + 1)
        inter = iw * ih
        union = w[i] * h[i] + w[j] * h[j] - inter
        keep[j[(union > 0) & (2 * inter > union)]] = False
    return pairs


def nms_kernel_phase(torch, np, jax_pkg):
    """nms_keep bitwise against its plain version at every K and case, then
    its timing row at the tflite-ssd lowering's K."""
    from nnstreamer_tpu_torch.ops import nms as N

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    for k in NMS_KS:
        for name, *arrays in nms_cases(np, rng, k):
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
            got = N.pallas_nms_keep(*args)
            want = N.nms_keep(*args)
            torch.cuda.synchronize()
            check(got.dtype == torch.bool and got.shape == (k,),
                  f"nms_keep K={k} {name}: dtype/shape {got.dtype}{tuple(got.shape)}")
            check(torch.equal(got, want), f"nms_keep K={k} {name}: not bitwise equal to its "
                                          "plain version")
            branch = "bit walk" if k <= N.BITS_MAX_K else "barrier walk"
            print(f"nms_keep K={k} {name} ({branch}): bitwise equal ({int(got.sum())} kept)",
                  flush=True)

    k = NMS_TIMED_K
    # The timed boxes come from their own seed, whatever cases run above.
    arrays = nms_cases(np, np.random.default_rng(2), k)[0][1:5] + (np.ones(k, bool),)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    pairs = nms_pairs(np, *arrays)
    t_bytes, by = bound_ms(4 * 4 * k + 2 * k, 16 * pairs + 3 * k, "float32")
    row = timed(
        dict(name="nms_keep", route="cuda", source="nnstreamer_tpu_torch/csrc/nms_keep.cu",
             replaces=f"{jax_pkg}/ops/nms.py:89", max_abs_err=0.0, bound_ms=t_bytes,
             bound_by=by, pairs_tested=pairs,
             shape=f"K={k} boxes, float32 x/y/w/h + bool valid -> bool keep"),
        kernel=lambda: N.pallas_nms_keep(*args), plain=lambda: N.nms_keep(*args))
    one = [torch.ones(1, device=dev) for _ in range(4)] + [torch.ones(1, dtype=torch.bool,
                                                                      device=dev)]
    row["launch_floor_ms"], row["launch_floor_timer"] = device_ms(
        lambda: N.pallas_nms_keep(*one), activities=1)
    return row


def timed(row, kernel, plain, library=None):
    """Fill a kernel-table row with the device time per call of the kernel,
    its plain version and the library call, and the kernel's time per
    back-to-back call (host dispatch included)."""
    row["ms"], row["timer"] = device_ms(kernel, activities=1)
    row["plain_ms"] = device_ms(plain, iters=50)[0] if plain is not None else None
    row["library_ms"] = device_ms(library)[0] if library is not None else None
    row["call_ms"] = call_ms(kernel)
    return row


def slice_phase(torch, np, K, bind):
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.ops.quant import quantize_activations

    t0 = time.perf_counter()
    model = mobilenet_v2.build_quantized(num_classes=CLASSES, width_mult=1.0, image_size=IMAGE,
                                         int8_head=True, seed=0, device="cuda")
    print(f"model built in {time.perf_counter() - t0:.3f} s", flush=True)
    labels = [f"class_{i}" for i in range(CLASSES)]

    def run(frames):
        arrivals = []
        p = nns.Pipeline()
        src = p.add(nns.make("videotestsrc", num_buffers=frames, width=IMAGE, height=IMAGE,
                             pattern="random", seed=7))
        conv = p.add(nns.make("tensor_converter"))
        norm = p.add(nns.make("tensor_transform", mode="arithmetic", option=NORMALIZE,
                              acceleration="pallas", device="cuda"))
        filt = p.add(TensorFilter(framework="torch", model=model))
        dec = p.add(nns.make("tensor_decoder", mode="image_labeling"))
        dec.plugin.set_labels(labels)
        sink = p.add(TensorSink(collect=True,
                                callback=lambda f: arrivals.append(time.perf_counter())))
        p.link_chain(src, conv, norm, filt, dec, sink)
        p.run(timeout=600)
        return sink.frames, arrivals, src

    run(WARMUP_FRAMES)  # CUDA context, cuDNN plans, kernel libraries
    K.reset_launches()
    frames, arrivals, src = run(FRAMES)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    print(f"image-labeling path launches over {FRAMES} frames: {launches}", flush=True)
    check(len(frames) == FRAMES, f"slice delivered {len(frames)} of {FRAMES} frames")
    for name in ("fused_arith", "int8_matmul"):
        check(launches[name] == FRAMES,
              f"{name} launched {launches[name]} times for {FRAMES} frames")

    # The same model with the kernels' plain versions, on the card.
    ops = bind(NORMALIZE, np.dtype(np.uint8))
    head = model.params["classifier"]
    plain_idx, plain_top = [], []
    with torch.inference_mode():
        for i in range(FRAMES):
            x = torch.from_numpy(src._make_frame(i)).cuda()
            feats = mobilenet_v2.features(model.params, K.fused_arith_plain(x, ops)[None])
            q, s = quantize_activations(feats.to(torch.float32))
            logits = K.int8_matmul_plain(q, head["w"].q, s, head["w"].scale, head["b"])[0]
            check(bool(torch.isfinite(logits).all()) and logits.shape == (CLASSES,),
                  f"frame {i}: plain logits not finite / wrong shape")
            plain_idx.append(int(torch.argmax(logits)))
            plain_top.append(float(logits.max()))
    got_idx = [f.meta["label_index"] for f in frames]
    check(got_idx == plain_idx, f"labels differ from the plain run: {got_idx} vs {plain_idx}")
    check([f.meta["label"] for f in frames] == [labels[i] for i in plain_idx],
          "label text does not match the label index")
    # The trunk is the same cuDNN/cuBLAS code in both runs and both kernels
    # are bitwise equal to their plain versions, so the top logits should be
    # equal; allowed: 1e-3 relative, for a conv algorithm picked differently
    # from one call to the next.
    top_err = max(abs(f.meta["score"] - t) / max(1.0, abs(t)) for f, t in zip(frames, plain_top))
    check(top_err <= 1e-3, f"top logits differ from the plain run by {top_err} (relative)")

    # Whole logits of the first frames: the model with its kernels against
    # the model with their plain versions, on the same normalized input.
    logit_err = 0.0
    with torch.inference_mode():
        for i in range(8):
            x = torch.from_numpy(src._make_frame(i)).cuda()
            got = model(K.fused_arith(x, ops))
            feats = mobilenet_v2.features(model.params, K.fused_arith_plain(x, ops)[None])
            q, s = quantize_activations(feats.to(torch.float32))
            want = K.int8_matmul_plain(q, head["w"].q, s, head["w"].scale, head["b"])[0]
            logit_err = max(logit_err, float((got - want).abs().max() / want.abs().max()))
    check(logit_err <= 1e-3, f"logits differ from the plain run by {logit_err} (relative)")

    gaps = np.diff(np.asarray(arrivals)) * 1e3
    fps = (len(arrivals) - 1) / (arrivals[-1] - arrivals[0])
    slice_res = dict(frames=FRAMES, fps=fps, p50_ms=float(np.median(gaps)),
                     p90_ms=float(np.percentile(gaps, 90)),
                     distinct_labels=len(set(got_idx)), top_logit_rel_err=top_err,
                     logit_rel_err=logit_err)
    print(f"slice: {FRAMES} frames, {fps:.3f} fps, p50 {slice_res['p50_ms']:.3f} ms/frame, "
          f"labels equal to the plain run ({len(set(got_idx))} distinct), logits within "
          f"{logit_err:.3g} (relative)", flush=True)

    profile_slice(lambda: run(PROFILED), slice_res)
    return launches, slice_res


def profile_slice(run_profiled, res):
    """Where a frame's time goes: a separate profiled run of PROFILED frames
    (not counted in the timed run); device busy time against wall time."""
    t0 = time.perf_counter()
    busy_ms, activities = profile_cuda(run_profiled, 1)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if busy_ms is None:
        print("profiled run: the profiler recorded no device time (not measured)", flush=True)
        return
    # The profiler slows the host down, so the idle share is taken against
    # the unprofiled run's wall time per frame.
    busy = busy_ms / PROFILED
    res.update(profiled_frames=PROFILED, device_busy_ms_per_frame=busy,
               profiled_wall_ms_per_frame=wall_ms / PROFILED,
               device_idle_share=1 - busy * res["fps"] / 1e3,
               device_activities_per_frame=activities / PROFILED)
    print(f"profiled {PROFILED} frames: device busy {busy:.3f} ms/frame, idle "
          f"{res['device_idle_share']:.3f} of the unprofiled {1e3 / res['fps']:.3f} ms/frame, "
          f"{activities / PROFILED:.0f} kernels and copies per frame", flush=True)


def _objects(frame):
    return [(o.class_id, o.x, o.y, o.width, o.height) for o in frame.meta["objects"]]


def detection_phase(torch, np, K, bind, root):
    """Slice 2: the object-detection pipeline at full width, with
    whole-segment compilation and the NMS kernel; then its fused-decode
    variant."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.decoders import bounding_boxes as bb
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.models import ssd_mobilenet

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    labels = os.path.join(work, "labels.txt")
    with open(labels, "w", encoding="utf-8") as f:
        f.write("\n".join(["background"] + [f"object_{i}" for i in range(1, SSD_LABELS)]))
    priors_path = ssd_mobilenet.write_priors_file(os.path.join(work, "priors.txt"), SSD_IMAGE)
    t0 = time.perf_counter()
    kw = dict(num_labels=SSD_LABELS, image_size=SSD_IMAGE, seed=0, device="cuda")
    model = ssd_mobilenet.build(**kw)
    fused_model = ssd_mobilenet.build(fused_decode=SSD_TOPK, **kw)
    print(f"SSD models built in {time.perf_counter() - t0:.3f} s "
          f"({ssd_mobilenet.num_priors(SSD_IMAGE)} anchors)", flush=True)
    wh = f"{SSD_IMAGE}:{SSD_IMAGE}"

    def run(m, frames, seg, submode):
        arrivals = []
        p = nns.Pipeline()
        p.segment_compile = seg
        src = p.add(nns.make("videotestsrc", num_buffers=frames, width=SSD_IMAGE,
                             height=SSD_IMAGE, pattern="random", seed=11))
        conv = p.add(nns.make("tensor_converter"))
        norm = p.add(nns.make("tensor_transform", mode="arithmetic", option=NORMALIZE,
                              acceleration="pallas", device="cuda"))
        filt = p.add(TensorFilter(framework="torch", model=m))
        dec = p.add(nns.make("tensor_decoder", mode="bounding_boxes", option1=submode,
                             option2=labels, option3=priors_path, option4=wh, option5=wh))
        sink = p.add(TensorSink(collect=True,
                                callback=lambda f: arrivals.append(time.perf_counter())))
        p.link_chain(src, conv, norm, filt, dec, sink)
        p.start()
        try:
            state = dict(converter_folded=conv.name not in p.nodes,
                         transform_folded=norm.name not in p.nodes,
                         decoder_lowered=dec.plugin._lowered is not None,
                         label=filt.backend.segment_label, fn=filt.backend._fn)
            check(p.wait(600), "the detection pipeline did not finish within 600 s")
        finally:
            p.stop()
        check(len(sink.frames) == frames, f"detection delivered {len(sink.frames)} of {frames}")
        return sink.frames, arrivals, state, src

    run(model, WARMUP_FRAMES, True, "tflite-ssd")  # cuDNN plans for the new shapes
    K.reset_launches()
    frames, arrivals, state, src = run(model, FRAMES, True, "tflite-ssd")
    launches = {k.__name__: k.launches for k in K.KERNELS}
    fused_fn = state.pop("fn")
    print(f"object-detection path launches over {FRAMES} frames: {launches}; segment "
          f"{state}", flush=True)
    check(state["converter_folded"] and state["transform_folded"] and state["decoder_lowered"],
          f"the segment did not fold the converter, transform and decoder: {state}")
    for name in ("fused_arith", "pallas_nms_keep"):
        check(launches[name] == FRAMES,
              f"{name} launched {launches[name]} times for {FRAMES} frames")
    gaps = np.diff(np.asarray(arrivals)) * 1e3
    res = dict(frames=FRAMES, fps=(len(arrivals) - 1) / (arrivals[-1] - arrivals[0]),
               p50_ms=float(np.median(gaps)), p90_ms=float(np.percentile(gaps, 90)),
               segment=state["label"])

    # The filter's fused function (normalize, SSD, decode, sort, NMS) makes
    # no host synchronization: one call on a frame already on the card, with
    # PyTorch's sync debug mode raising on any synchronizing operation.
    x = torch.from_numpy(src._make_frame(0)).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            det = fused_fn(x)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(det.shape) == (bb.PRE_NMS_TOP_K, 6) and bool(torch.isfinite(det).all()),
          f"fused function output {tuple(det.shape)} not finite / wrong shape")
    print("fused function: no host synchronization from the normalize to the NMS",
          flush=True)

    # The same frames with segments off: decode and NMS on the host.
    host, host_arrivals, hstate, _ = run(model, FRAMES, False, "tflite-ssd")
    check(not hstate["decoder_lowered"], "segments off, yet the decoder was lowered")
    host_gaps = np.diff(np.asarray(host_arrivals)) * 1e3
    res.update(host_fps=(len(host_arrivals) - 1) / (host_arrivals[-1] - host_arrivals[0]),
               host_p50_ms=float(np.median(host_gaps)))
    prob_err, n_objects = 0.0, 0
    for i, (g, w) in enumerate(zip(frames, host)):
        check(_objects(g) == _objects(w), f"frame {i}: device detections {_objects(g)} differ "
                                          f"from the host decode {_objects(w)}")
        for a, b in zip(g.meta["objects"], w.meta["objects"]):
            prob_err = max(prob_err, abs(a.prob - b.prob))
        n_objects += len(g.meta["objects"])
    check(prob_err <= PROB_ATOL, f"probs differ from the host decode by {prob_err}")

    # Candidates and survivors of the first frames, from the raw model output
    # decoded on the host: the NMS must keep some boxes and suppress others.
    ops = bind(NORMALIZE, np.dtype(np.uint8))
    priors = ssd_mobilenet.generate_priors(SSD_IMAGE)
    candidates = kept = max_area = 0
    with torch.inference_mode():
        for i in range(4):
            x = K.fused_arith_plain(torch.from_numpy(src._make_frame(i)).cuda(), ops)
            boxes, scores = model(x)
            n = ssd_mobilenet.num_priors(SSD_IMAGE)
            check(boxes.shape == (n, 4) and scores.shape == (n, SSD_LABELS)
                  and bool(torch.isfinite(boxes).all()) and bool(torch.isfinite(scores).all()),
                  f"frame {i}: raw SSD outputs not finite / wrong shape")
            cands = bb.decode_tflite_ssd(boxes.cpu().numpy(), scores.cpu().numpy(), priors,
                                         SSD_IMAGE, SSD_IMAGE)
            survivors = bb.nms(cands)
            check([(o.class_id, o.x, o.y, o.width, o.height) for o in survivors]
                  == _objects(host[i]), f"frame {i}: host decode of the raw output differs")
            candidates += min(len(cands), bb.PRE_NMS_TOP_K)
            kept += len(survivors)
            max_area = max([max_area] + [o.width * o.height for o in cands])
    check(0 < kept < candidates, f"NMS kept {kept} of {candidates} candidates: trivial")
    res.update(objects=n_objects, prob_max_abs_err=prob_err, nms_candidates_4_frames=candidates,
               nms_kept_4_frames=kept, max_candidate_area=max_area)
    print(f"object detection: {FRAMES} frames, {res['fps']:.3f} fps, p50 {res['p50_ms']:.3f} "
          f"ms/frame (segments off: {res['host_fps']:.3f} fps, p50 {res['host_p50_ms']:.3f} "
          f"ms/frame); {n_objects} detections equal to the host decode (prob within "
          f"{prob_err:.3g}); NMS kept {kept} of {candidates} candidates in 4 frames; largest "
          f"candidate area {max_area} px", flush=True)
    profile_slice(lambda: run(model, PROFILED, True, "tflite-ssd"), res)

    # The fused-decode variant: decode_topk in the model, fused-ssd decoder.
    K.reset_launches()
    fused_on, _, fstate, _ = run(fused_model, FUSED_FRAMES, True, "fused-ssd")
    del fstate["fn"]
    fused_nms = {k.__name__: k.launches for k in K.KERNELS}["pallas_nms_keep"]
    fused_off, _, _, _ = run(fused_model, FUSED_FRAMES, False, "fused-ssd")
    check(fstate["decoder_lowered"] and fused_nms == FUSED_FRAMES,
          f"fused-ssd: lowered {fstate['decoder_lowered']}, {fused_nms} nms_keep launches")
    fused_objects = 0
    for i, (a, b) in enumerate(zip(fused_on, fused_off)):
        check([vars(o) for o in a.meta["objects"]] == [vars(o) for o in b.meta["objects"]],
              f"fused-ssd frame {i}: segments on and off disagree")
        check(a.tensor(0).numpy().tobytes() == b.tensor(0).numpy().tobytes(),
              f"fused-ssd frame {i}: overlays differ")
        fused_objects += len(a.meta["objects"])
    check(fused_objects > 0, "fused-ssd: no detections")
    res.update(fused_frames=FUSED_FRAMES, fused_objects=fused_objects)
    print(f"fused-ssd: {FUSED_FRAMES} frames, segments on and off bitwise equal "
          f"({fused_objects} detections, {fused_nms} nms_keep launches)", flush=True)
    return launches, res


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import nnstreamer_tpu_torch
        from nnstreamer_tpu_torch.elements.transform import _bind_chain, _parse_arith_ops, \
            _parse_clamp
        from nnstreamer_tpu_torch.ops import build
        from nnstreamer_tpu_torch.ops import kernels as K
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    # The JAX reference package (never imported) sits beside the port, under
    # the port's name without "_torch"; the kernel table names its files.
    jax_pkg = nnstreamer_tpu_torch.__name__[: -len("_torch")]

    def bind(option, dtype):
        """A transform option as a bound kernel chain; ``clamp:lo:hi`` may
        appear as a step, as the clamp mode passes it."""
        ops = []
        for part in option.split(","):
            if part.startswith("clamp:"):
                ops.append(("clamp", _parse_clamp(part[6:])))
            else:
                ops.extend(_parse_arith_ops(part))
        return _bind_chain(ops, dtype)

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    # No float32 comparison here may run in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convs and matmuls", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.3f} s ({', '.join(build.SOURCES)})", flush=True)
    for name, log in logs.items():
        if name == "fused_arith":
            continue
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    # fused_arith: 72 instantiations (8 float32-chain, 64 general), summed up
    report = build.ptxas_report(build.log_path("fused_arith").read_text())
    ptxas = dict(entries=len(report), max_registers=max(r["registers"] for r in report.values()),
                 max_stack_bytes=max(r["stack"] for r in report.values()),
                 spill_bytes=sum(r["spill_stores"] + r["spill_loads"] for r in report.values()))
    print(f"  fused_arith: ptxas -v over {ptxas['entries']} entries: at most "
          f"{ptxas['max_registers']} registers, {ptxas['max_stack_bytes']} bytes stack frame, "
          f"{ptxas['spill_bytes']} bytes spilled", flush=True)
    check(ptxas["max_stack_bytes"] == 0 and ptxas["spill_bytes"] == 0,
          f"fused_arith has a stack frame or spills: {ptxas}")

    kernels = kernel_phase(torch, np, K, bind, jax_pkg)
    kernels["fused_arith"]["ptxas"] = ptxas
    by_path = {"image_labeling": slice_phase(torch, np, K, bind)}
    by_path["object_detection"] = detection_phase(torch, np, K, bind, root)
    wrapper = {"fused_arith": "fused_arith", "int8_matmul": "int8_matmul",
               "nms_keep": "pallas_nms_keep"}
    for name, r in kernels.items():
        counts = {path: launches[wrapper[name]] for path, (launches, _) in by_path.items()}
        r["launches"] = sum(counts.values())
        r["launches_by_path"] = counts
        check(r["launches"] > 0, f"{name} never launched on a main path")
    print(json.dumps({"card": card, "build_s": build_s,
                      "slice": by_path["image_labeling"][1],
                      "slice2": by_path["object_detection"][1]}), flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   uint16), the audio path's normalize, (16000, 1) int16 -> float32, and
   bfloat16: the normalize ending in ``typecast:bfloat16`` at (224,224,3)
   uint8, the audio normalize on a (16000, 1) bfloat16 window (both also
   misaligned), a bfloat16 chain with a division and a clamp, a clamp at
   -1:0 (signed zeros), bfloat16 to int8 with NaN and inf, and int32 to
   bfloat16 (two roundings through float32); the bfloat16 inputs hold
   subnormals, which float arithmetic flushes to zeros of their sign, as
   XLA does (ROADMAP C6), in the kernel as in its plain version; and C6's
   own inputs, float32 1e-39 and -5.8e-39 and bfloat16 bits 0x0001,
   0x007F and 0x8001, under ``mul:2``, ``div:2`` and ``clamp:-1:1``, each
   of which must give the zero of the input's sign; and XLA's folds
   (ROADMAP C7 to C9) at (224,224,3): the multiply-first normalize (one
   ``ffma`` step), float32 chains with folded literals and two fused
   multiply-adds, float16 chains (``hfma``, a fold in XLA's order), and
   float32 values whose float64 ``x * b + c`` lands on a float32 midpoint;
   and the lanes that a float -> int conversion saturated before a fused
   multiply-add, which take a multiply and an add (ROADMAP C10), and keep
   doing so through a second conversion only where the program's reset
   bit says (C13: ROADMAP C13's input chain and two probed classes, their
   reset bits checked on the host); then ``int8_matmul`` at M = 2, 4, 8,
   16 (split-K) and 32 (tiled) x (1280, 1001), exact in int32 and within
   1 ulp, and ``fused_arith``'s normalize at (4, 224, 224, 3) and (8, 224,
   224, 3), bitwise, each timed beside its bound (``int8_matmul`` beside
   ``torch._int_mm`` at the same M).
   Then it times kernel, plain version and, where one exists, the one
   PyTorch call that computes the same function (a yardstick only; the
   port never calls it); each kernel at its smallest case as its launch
   floor; ``fused_arith`` also at the 4K frame and the audio window and,
   beside it, ``x.to(torch.float32)`` on the same frames (the same bytes and
   one conversion, a yardstick for the chain), and the two bfloat16 chains
   at the path's shapes beside their bytes bound, their launch floor and
   the cast to their output dtype, and the multiply-first normalize;
4. graph phase: each kernel captured in a CUDA graph (``fused_arith`` at
   the three paths' frames and the two bfloat16 chains, ``int8_matmul`` on its split-K cluster branch and
   its tiled branch, ``nms_keep`` on its bit walk, its barrier walk and
   above the static shared-memory limit) and replayed twice on new inputs,
   held against its plain version as in the kernel phase;
5. image-labeling phase (slice 1): builds MobileNet-v2 1.0 (224x224x3 uint8
   frames, 1001 classes, bf16, int8 classifier head, random weights from a
   fixed seed) and runs 64 ``videotestsrc`` frames on the card through the
   canonical topology, built by ``parse_launch``: ``videotestsrc !
   tensor_converter ! tensor_transform (normalize, pallas) ! tensor_upload !
   queue ! tensor_filter ! tensor_decoder (image_labeling) ! tensor_sink``.
   The normalize folds into the filter across the upload and the queue; the
   backend captures the folded function once (one capture, a replay per
   frame), so each wrapper launches only in the pre-capture warm-up calls
   and the capture.  The replays must equal the
   eager call of the same function on the same frames (logits bitwise, or
   within 1e-3 relative if a conv algorithm was picked differently), their
   outputs must be distinct tensors, and the labels must equal those of the
   same model run with the kernels' plain versions.  A traced run of 16
   frames, gated so that its window holds the frames and not the capture,
   must hold 16 graph launches, each with one CUPTI record of each path
   kernel and none of the others (``launch_check``: a launch may lack a
   record only where its own record count shows that the tracer lost
   it); it gives device busy time, idle
   share and host-issued device operations per frame.  The filter's
   function is also run eagerly and replayed in a plain frame loop, for fps
   and host operations per frame;
6. object-detection phase (slice 2): builds SSD-MobileNet-v2 1.0 (300x300x3
   uint8 frames, 1917 anchors, 91 labels, bf16, random weights from a fixed
   seed) and runs 64 frames through the same topology with the tflite-ssd
   decoder and whole-segment compilation on: the converter, the normalize
   and the decoder's device part fold into the filter, one capture, a
   replay per frame; the replays must equal the eager call bitwise, and the
   detections those of the same frames decoded on the host (boxes and
   classes exactly, probs within ``PROB_ATOL``); then the fused-decode
   variant (``fused_decode=100``, ``fused-ssd`` decoder) with segments on
   and off must agree bitwise;
7. obs phase: slices 1 and 2 again from their launch strings, 64 frames
   each, with the ``latency``, ``stats``, ``drops``, ``copies`` and
   ``spans`` tracers attached and a scrape endpoint on an ephemeral port:
   prints the source->sink latency (p50, p90, p99), each element's
   dispatch time a frame from the spans (its span, and its own time
   without the dispatches nested in it), host copies a frame (the upload's
   one, which it must be) and drops, fps with and without the tracers;
   scrapes ``/metrics`` (the latency histogram must count every frame
   delivered) and ``/stats.json``; writes the Chrome trace to
   ``build/chip_smoke/`` and reads it back; then a traced run with the
   tracers and profiling on must pass the per-frame launch check with 5
   host-issued operations a frame, and the filter's profiled invoke p50
   must be at least 0.9 of the device's busy time a frame (the profiled
   invoke waits for its outputs);
8. audio phase: builds the 1-D conv keyword-spotting classifier
   (``models/audio_cnn``: a 16000 x 1 window of 16 kHz S16LE audio,
   channels (32, 64, 64), width 9, 12 classes, bf16, random weights from a
   fixed seed) and runs 64 windows through ``audiotestsrc ! tensor_converter
   ! tensor_aggregator frames-out=10 frames-dim=1 ! tensor_transform
   (int16 -> float32 normalize, pallas) ! tensor_upload ! queue !
   tensor_filter ! tensor_decoder (image_labeling, 12 labels) !
   tensor_sink``, read through ``connect("new-data", ...)``.  The
   normalize folds into the filter across the upload and the queue: one
   capture, a replay per window, ``fused_arith`` called 4 times and the
   other kernels never; the labels must equal those of the eager call of
   the same function on the card, the replayed logits those of the port's
   CPU run (plain ``fused_arith``) within 1/32 of the largest logit (bf16)
   with equal top-1 labels, and the 16-window trace must hold one
   ``fused_arith`` record per graph launch and none of the others;
9. upload-wait phase: ``datasrc ! tensor_converter input-dim=8192:4096
   input-type=uint8 ! tensor_upload ! queue ! tensor_sink``, 32 MiB frames,
   the upload's stream held back about 0.1 s before each copy; a
   ``new-data`` callback reads each frame with ``.cpu()`` and must get the
   source bytes (the sink's dispatch waits for the copy);
10. model-file phase (models named in the launch string): writes MobileNet-v2 1.0's seed-0
   params in the JAX package's layout with the port's ``save_state`` and
   runs 64 640x480 ``videotestsrc`` frames through a launch string that
   names everything: ``tensor_filter framework=custom-python`` with the
   port's example scaler (``custom=224x224``), the normalize, ``tensor_upload
   ! queue``, ``tensor_filter framework=torch model=<file>.npz
   custom=builder=mobilenet_v2:build_quantized,int8_head=1``, the labeling
   decoder.  One capture, 64 replays, ``fused_arith`` and ``int8_matmul``
   called 4 times each and ``nms_keep`` never, labels equal to the builder
   called directly on the same tree and scaled frames, and the 16-frame
   trace's per-launch check;
11. TorchScript phase: MobileNet-v2 1.0 (bf16) traced on the card, saved,
   and named in slice 1's string (``model=<file>.pt``) for 16 frames: one
   capture, replays within 1e-3 relative of the eager call;
12. drift phase: frames of (224,224,3) uint8, (300,300,3), (224,224,3) and
   an int16 frame reach a filter with the normalize folded in with no caps
   event: 3 captures (two while the pipeline plays) and 1 LRU hit, each
   output bitwise equal to eager, the int16 frame computed as int16;
13. custom-so phase: a C filter built with ``g++`` here, behind
   ``tensor_upload ! queue``, gets its 8 frames on the card, copies them to
   the host and returns exactly ``x * 10``;
14. quant phase (the full-int8 trunk): config 1q, slice 1's string with
   ``model=<npz> custom=builder=mobilenet_v2:build_quantized,int8_convs=1,
   static_scales=1`` (35 int8 convs on ``torch._int_mm``, scales calibrated
   when the filter opens), 64 frames: one capture, the replays equal to
   eager bit for bit, the labels equal to the builder's called directly,
   the card's logits within QUANT_LOGIT_REL_TOL of the port's CPU forward
   on the same params and scales; a 16-frame traced run with 5 host
   operations, one ``fused_arith`` and 35 int8 GEMM records (cuBLASLt's,
   by name) a launch; the same string with ``int8_head=1`` (one
   ``int8_matmul`` record more); the int8 SSD through slice 2's string
   (50 int8 GEMMs and one ``nms_keep`` a launch, detections equal to the
   host decode of the eager forward); the device time a frame split into
   int8 GEMM, quantize and rescale, depthwise conv and other;
15. pose phase (config 3): PoseNet (MobileNet-v2 1.0 truncated at stride 16,
   a 1x1 head to 14 heatmaps, bf16, seed-0 weights) named in slice 1's
   string (``model=<posenet.npz> custom=builder=posenet:build,fused_decode=1``,
   ``tensor_decoder mode=pose_estimation option1=224:224 option2=14:14
   option3=<joints>``), 64 frames: one capture, the replays equal to eager
   bit for bit, each frame's keypoints equal to the numpy argmax over the
   card's eager heatmaps and, on 8 frames, to the port's CPU forward's
   wherever a channel's top-1 leads by more than POSE_MARGIN; a 16-frame
   trace with 5 host operations and one ``fused_arith`` record a launch;
   then the heatmap form (``fused_decode`` off, the decoder's host argmax)
   and ``posenet:build_quantized`` (27 int8 GEMMs a launch), 16 frames each;
16. recurrence phase (config 4 and 4b): the LSTM cell (``lstm.build_cell``,
   hidden 64) in the repo-slot cycle of ``examples/pipelines/
   recurrence_lstm.py`` (repo sources for h and c on the card, a data source
   for x, ``tensor_mux sync-mode=nosync``, the filter, ``tensor_demux``, a
   tee, repo sinks) for 200 steps: one capture, every h equal to the eager
   cell fed the same states bit for bit and within LSTM_CPU_ATOL of the
   port's CPU forward; a 16-step trace with no device-to-host copy (CUPTI)
   and none in the ``copies`` tracer; stopped after 100 steps,
   ``checkpoint_pipeline``, a new pipeline, ``restore_pipeline``, 100 more:
   every h equal to the uninterrupted run's; then ``lstm.build_sequence``
   (input and hidden 512, 128 steps a window) through ``datasrc !
   tensor_upload ! queue ! tensor_filter ! tensor_sink``, 32 windows: one
   capture, replays equal to eager bit for bit, within SEQ_CPU_ATOL of the
   CPU forward;
17. batch phase (config 5 and config 1d): MobileNet-v2 1.0 (seed-0
   weights, bf16) from a checkpoint named in config 5's string,
   ``datasrc``x N ``! tensor_mux sync_mode=nosync ! tensor_batch !`` the
   normalize ``! tensor_upload ! queue ! tensor_filter`` (``batch=N``) ``!
   tensor_unbatch ! tensor_demux !`` N sinks, 24 rounds at N=4 (the float
   head) and N=8 (``build_quantized,int8_head=1``): one capture, a replay a
   round, each wrapper called only in the capture's warm-up and the
   capture; every stream's frames equal, in order, the rows of the eager
   forward of the same batch bit for bit; rows within BATCH_LOGIT_REL
   (int8 head: BATCH_INT8_LOGIT_REL) of the batch-1 forward, top-1 equal,
   and every row farther than that from any other frame's forward; a
   16-round trace with 5 host operations and one record of each path
   kernel a launch. Config 1d: ``datasrc ! tensor_dynbatch max_batch=8 !``
   the normalize ``! tensor_upload ! queue ! tensor_filter ! tensor_dynunbatch
   ! tensor_sink`` on the int8-head model with a ``(None, 224, 224, 3)``
   input, ``[compile] warmup`` on: 4 captures before the first frame and
   none while PLAYING, 96 frames out in pts order, each batch's rows equal
   to the eager forward of the same rows (the frames of each batch
   recorded as it leaves dynbatch); then a coverage run (made-up bursts
   of 1 to 8 frames, to reach every bucket) traced: a graph launch a batch, with one ``fused_arith`` and one
   ``int8_matmul`` record, the head at M = the batch's bucket. Last the
   pool's fence: config 5 with the upload's stream held before each copy;
   a recycled lease waits for the copy that reads it, and every round's
   rows stay those of its own frames;
18. prints every path number beside the card's name and power limit, one
   JSON line describing every kernel, and last one JSON line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Without a CUDA GPU, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

FRAMES = 64
WARMUP_FRAMES = 4
PROFILED = 16
IMAGE = 224
CLASSES = 1001
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
# The normalize written multiply-first: one fused multiply-add (ffma)
MUL_FIRST_NORMALIZE = "typecast:float32,mul:0.00784313725,add:-1.0"
# x * 38737 * 2**-30 + 2**30: the float64 sum of 1774001 * b lands on a
# float32 midpoint, the exact sum above it; rounding twice misses
# ROADMAP C13's input chain (float16 in): int32, a float clamp, uint16, a
# fused multiply-add.
C13_CHAIN = ("typecast:int32,clamp:1.0330171742977412:221.0729442728292,typecast:uint16,"
             "mul:-0.42657339572906494,add:-1.033626914024353,sub:226")
FMA_MIDPOINTS = f"mul:{38737 * 2.0 ** -30!r},add:{2.0 ** 30!r}"
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
# The audio path: Speech Commands v2's 12-class keyword spotting, 1 s windows
# of 16 kHz S16LE audio made of 10 blocks of 1600 samples.
AUDIO_RATE = 16000
AUDIO_BLOCK = 1600
AUDIO_WINDOW = 16000
AUDIO_CLASSES = 12
AUDIO_NORMALIZE = "typecast:float32,div:32768.0"
# bf16 layers round to 8 significant bits: the card's convs sum in another
# order than the CPU's, so a value may move by an ulp a layer.
AUDIO_LOGIT_REL = 1 / 32
# The upload-wait phase: 32 MiB frames, the upload's stream held ~0.1 s
# (at the H100's 1.98 GHz) before each copy.
UPLOAD_FRAME_DIMS = "8192:4096"
UPLOAD_FRAMES = 4
UPLOAD_HOLD_CYCLES = 200_000_000
# The model-file path: camera frames the scaler custom filter takes to
# IMAGE x IMAGE, MobileNet-v2 from a checkpoint named in the launch string.
CAMERA = (480, 640)
BF16_NORMALIZE = NORMALIZE + ",typecast:bfloat16"
TS_FRAMES = 16          # the TorchScript file through slice 1's string
SO_FRAMES = 8           # the custom-so filter behind an upload
SO_SCALE = "10.0"
# tests/test_custom_so.py's scaler: a (3,4) float32 tensor times nns_init's scale.
SCALER_SO_SRC = r"""
#include <cstdlib>
#include "nns_custom_filter.h"

static float g_scale = 2.0f;

extern "C" int nns_init(const char *custom) {
  if (custom && custom[0]) g_scale = atof(custom);
  return 0;
}

extern "C" int nns_get_input_spec(nns_tensors_spec *spec) {
  spec->num_tensors = 1;
  spec->tensors[0].dtype = NNS_FLOAT32;
  spec->tensors[0].rank = 2;
  spec->tensors[0].dims[0] = 3;
  spec->tensors[0].dims[1] = 4;
  return 0;
}

extern "C" int nns_get_output_spec(nns_tensors_spec *spec) {
  return nns_get_input_spec(spec);
}

extern "C" int nns_invoke(const void *const *in, const uint64_t *in_sz,
                          void *const *out, const uint64_t *out_sz) {
  if (in_sz[0] != out_sz[0]) return -1;
  const float *src = (const float *)in[0];
  float *dst = (float *)out[0];
  for (uint64_t i = 0; i < in_sz[0] / sizeof(float); ++i)
    dst[i] = src[i] * g_scale;
  return 0;
}
"""
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
    from nnstreamer_tpu_torch.spec import numpy_dtype

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

    def bf16(shape):
        x = (rng.standard_normal(shape) * 300).astype(np.float32)
        x.flat[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 3e38]
        x.flat[6:10] = [1e-39, -1e-39, 5.8e-39, -9.2e-41]  # subnormals: arithmetic flushes them
        return torch.from_numpy(x).to(torch.bfloat16)

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
        ((AUDIO_WINDOW, 1), ints(np.int16, -32768, 32768), AUDIO_NORMALIZE, 0),
        # bfloat16 in, out and through; int32 -> bfloat16 rounds through float32
        ((IMAGE, IMAGE, 3), u8, BF16_NORMALIZE, 0),
        ((IMAGE, IMAGE, 3), u8, BF16_NORMALIZE, 1),
        ((AUDIO_WINDOW, 1), bf16, AUDIO_NORMALIZE, 0),
        ((AUDIO_WINDOW, 1), bf16, AUDIO_NORMALIZE, 1),
        ((100_003,), bf16, "add:0.1,mul:3.3,div:7,clamp:-1000:1000.5", 0),
        ((100_003,), bf16, "clamp:-1:0", 0),
        ((100_003,), bf16, "typecast:int8", 0),
        ((100_003,), ints(np.int32, -2 ** 31, 2 ** 31), "typecast:bfloat16", 0),
        ((100_003,), u8, "typecast:bfloat16,add:-127.5,div:127.5", 0),
        # XLA's folds (ROADMAP C7 to C9): literals folded, a multiply and an
        # add as one fused multiply-add (ffma; hfma in float16)
        ((IMAGE, IMAGE, 3), u8, MUL_FIRST_NORMALIZE, 0),
        ((IMAGE, IMAGE, 3), floats(np.float32), "mul:3,add:0.2", 0),
        ((IMAGE, IMAGE, 3), floats(np.float32), "add:0.1,mul:3,add:0.2,mul:0.5,sub:1", 0),
        ((IMAGE, IMAGE, 3), floats(np.float32), "add:0.1,add:0.2,add:0.3", 0),
        ((IMAGE, IMAGE, 3), floats(np.float32), "mul:3,div:3", 0),
        ((IMAGE, IMAGE, 3), floats(np.float16), "mul:1.5,add:0.0001", 0),
        ((IMAGE, IMAGE, 3), floats(np.float16), "mul:3,add:0.2,mul:7", 0),
        ((IMAGE, IMAGE, 3), floats(np.float16), "sub:3551.710205078125,add:1,add:-79", 0),
        ((5,), lambda shape: np.array([1774001.0, 233415.0, -1774001.0, 1.0, -3.0], np.float32),
         FMA_MIDPOINTS, 0),
        # ROADMAP C10: the lanes a float -> int conversion saturated take a
        # multiply and an add after it, the others one fused multiply-add
        ((IMAGE, IMAGE, 3), floats(np.float32), "typecast:int8,div:130,add:0.001", 0),
        ((IMAGE, IMAGE, 3), floats(np.float32),
         "typecast:uint8,add:3,typecast:float32,mul:1.37,add:0.0071", 0),
        ((IMAGE, IMAGE, 3), floats(np.float16),
         "typecast:int16,typecast:float16,mul:1.5,add:0.0001", 0),
        # ROADMAP C13: a second float -> int conversion drops those lanes
        # after a float step, or where LLVM's round trip is no int
        # conversion (the program's reset bit), and keeps them otherwise
        ((100_003,), floats(np.float16), C13_CHAIN, 0),
        ((IMAGE, IMAGE, 3), floats(np.float32),
         "typecast:int8,typecast:float32,typecast:int16,mul:1.37,add:0.0071", 0),
        ((IMAGE, IMAGE, 3), floats(np.float32),
         "typecast:int8,typecast:float32,typecast:uint16,mul:1.37,add:0.0071", 0),
    ]
    for dtype, option, reset in ((np.float16, C13_CHAIN, 4),
                                 (np.float32, "typecast:int8,typecast:float32,typecast:int16,"
                                              "mul:1.37,add:0.0071", 4),
                                 (np.float32, "typecast:int8,typecast:float32,typecast:uint16,"
                                              "mul:1.37,add:0.0071", 0)):
        got = K.fused_arith_plan(np.dtype(dtype), bind(option, np.dtype(dtype))).program.reset
        check(got == reset, f"'{option}': reset bits {got}, expected {reset}")
    err = 0.0
    for shape, make, option, offset in cases:
        x = make(shape)
        xd = (x if isinstance(x, torch.Tensor) else torch.from_numpy(x)).to(dev)
        dtype = numpy_dtype(xd.dtype)
        ops = bind(option, dtype)
        if offset:
            view = torch.empty(xd.numel() + offset, dtype=xd.dtype, device=dev)[offset:]
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
        where = f", {offset * xd.element_size()} bytes past a 16-byte boundary" if offset else ""
        print(f"fused_arith {dtype.name}{shape} '{option}'{where}: bitwise equal", flush=True)

    # C6: a subnormal operand of float arithmetic becomes the zero of its
    # sign, as XLA flushes it; the last lane (2.0) is a normal value.
    c6_bits = np.array([0x0001, 0x007F, 0x8001, 0x4000], np.uint16)
    for xd in (torch.tensor([1e-39, -5.8e-39, 2.0], dtype=torch.float32, device=dev),
               torch.from_numpy(c6_bits.view(np.int16)).view(torch.bfloat16).to(dev)):
        dtype = numpy_dtype(xd.dtype)
        for option in ("mul:2", "div:2", "clamp:-1:1"):
            c6_ops = bind(option, dtype)
            got = K.fused_arith(xd, c6_ops)
            want = K.fused_arith_plain(xd, c6_ops)
            torch.cuda.synchronize()
            check(bitwise_equal(torch, got, want),
                  f"fused_arith {option} on {dtype.name} subnormals: not bitwise equal")
            bits = got[:-1].view(torch.int16 if got.element_size() == 2 else torch.int32).cpu()
            signs = torch.signbit(xd[:-1].float()).cpu()
            zero = bits & ~(torch.tensor(1, dtype=bits.dtype) << (bits.element_size() * 8 - 1))
            check(bool((zero == 0).all()) and bool((torch.signbit(got[:-1].float()).cpu()
                                                    == signs).all()),
                  f"fused_arith {option} on {dtype.name} subnormals: {got.tolist()}, not "
                  "zeros of the inputs' signs")
            print(f"fused_arith {dtype.name} C6 subnormals '{option}': zeros of their sign, "
                  "bitwise equal", flush=True)

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
    # the audio path's window: (16000, 1) int16 -> float32
    xa = torch.from_numpy(rng.integers(-32768, 32768, (AUDIO_WINDOW, 1)).astype(np.int16)).to(dev)
    aops = bind(AUDIO_NORMALIZE, np.dtype(np.int16))
    n = xa.numel()
    t_bytes, by = bound_ms(n * 2 + n * 4, n * 2, "float32")
    row = timed(dict(shape=f"({AUDIO_WINDOW}, 1) int16 -> float32, '{AUDIO_NORMALIZE}'",
                     bound_ms=t_bytes, bound_by=by),
                kernel=lambda: K.fused_arith(xa, aops), plain=lambda: K.fused_arith_plain(xa, aops))
    row["cast_ms"] = device_ms(lambda: xa.to(torch.float32), activities=1)[0]
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    rows.append(row)
    # bfloat16: the normalize to bfloat16 at the path's frame (451,584 B),
    # and the audio window's normalize from bfloat16; the yardstick is the
    # cast to the output dtype, the same bytes
    xb = torch.from_numpy(rng.integers(0, 256, (IMAGE, IMAGE, 3)).astype(np.uint8)).to(dev)
    wb = bf16((AUDIO_WINDOW, 1)).to(dev)
    for x, option, out_dtype in ((xb, BF16_NORMALIZE, torch.bfloat16),
                                 (wb, AUDIO_NORMALIZE, torch.float32)):
        bops = bind(option, numpy_dtype(x.dtype))
        n = x.numel()
        t_bytes, by = bound_ms(n * x.element_size() + n * (2 if out_dtype == torch.bfloat16
                                                           else 4), n * 3, "float32")
        row = timed(dict(shape=f"{tuple(x.shape)} {numpy_dtype(x.dtype).name} -> "
                               f"{str(out_dtype)[6:]}, '{option}'",
                         bound_ms=t_bytes, bound_by=by),
                    kernel=lambda x=x, o=bops: K.fused_arith(x, o),
                    plain=lambda x=x, o=bops: K.fused_arith_plain(x, o))
        row["cast_ms"] = device_ms(lambda x=x, d=out_dtype: x.to(d), activities=1)[0]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        one = torch.zeros(1, dtype=x.dtype, device=dev)
        row["launch_floor_ms"] = device_ms(lambda one=one, o=bops: K.fused_arith(one, o),
                                           activities=1)[0]
        rows.append(row)
    # the normalize written multiply-first: one ffma step a value
    fops = bind(MUL_FIRST_NORMALIZE, np.dtype(np.uint8))
    check(K.fused_arith_plan(np.uint8, fops).program.op[-1] == K.OP["ffma"],
          f"'{MUL_FIRST_NORMALIZE}' did not lower to one fused multiply-add")
    n = xb.numel()
    t_bytes, by = bound_ms(n * 1 + n * 4, n * 2, "float32")
    row = timed(dict(shape=f"{tuple(xb.shape)} uint8 -> float32, '{MUL_FIRST_NORMALIZE}' (ffma)",
                     bound_ms=t_bytes, bound_by=by),
                kernel=lambda: K.fused_arith(xb, fops), plain=lambda: K.fused_arith_plain(xb, fops))
    row["cast_ms"] = device_ms(lambda: xb.to(torch.float32), activities=1)[0]
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    rows.append(row)
    results["fused_arith"] = rows[0]
    keys = ("shape", "ms", "plain_ms", "cast_ms", "call_ms", "bound_ms", "bound_by",
            "share_of_bound")
    rows[0]["ffma"] = {key: rows[6][key] for key in keys}
    rows[0]["at_detection_shape"] = {key: rows[1][key] for key in keys}
    rows[0]["at_4k"] = {key: rows[2][key] for key in keys}
    rows[0]["at_audio_shape"] = {key: rows[3][key] for key in keys}
    rows[0]["bf16_out"] = {key: rows[4][key] for key in keys + ("launch_floor_ms",)}
    rows[0]["bf16_in"] = {key: rows[5][key] for key in keys + ("launch_floor_ms",)}
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
    for key in ("at_detection_shape", "at_4k", "at_audio_shape", "bf16_out", "bf16_in"):
        r = results["fused_arith"][key]
        floor = f", launch floor {r['launch_floor_ms']} ms" if "launch_floor_ms" in r else ""
        print(f"fused_arith {r['shape']}: kernel {r['ms']} ms, plain {r['plain_ms']} ms, "
              f"cast to the output dtype {r['cast_ms']} ms, bound {r['bound_ms']} ms, "
              f"{r['share_of_bound']} of the bound{floor}", flush=True)
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


def graph_kernel_phase(torch, np, K, ops, audio_ops, bind):
    """Each kernel captured in a CUDA graph and replayed on new inputs, held
    bitwise against its plain version: the host entry points are
    capture-safe (int8_matmul's cluster launch on both branches, nms_keep
    above the static shared-memory limit, fused_arith's program copied into
    the graph node)."""
    from nnstreamer_tpu_torch.ops import nms as N
    from nnstreamer_tpu_torch.spec import numpy_dtype

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def u8(shape):
        return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))

    def i8(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    def f32(shape, scale=1.0):
        return torch.from_numpy(np.asarray(rng.random(shape) * scale, np.float32))

    def boxes(k):
        def make():
            xy = [torch.from_numpy(rng.integers(0, 300, k).astype(np.float32)) for _ in range(2)]
            wh = [torch.from_numpy(rng.integers(1, 150, k).astype(np.float32)) for _ in range(2)]
            return xy + wh + [torch.from_numpy(rng.random(k) < 0.8)]
        return make

    def matmul(m, k, n):
        return lambda: [i8((m, k)), i8((k, n)), f32((), 0.1) + 1e-3, f32((1, n), 0.01) + 1e-4,
                        f32((n,))]

    bf16_ops = bind(BF16_NORMALIZE, np.dtype(np.uint8))
    bf16_audio_ops = bind(AUDIO_NORMALIZE, numpy_dtype(torch.bfloat16))

    def bf16_window():
        x = np.asarray(rng.standard_normal((AUDIO_WINDOW, 1)) * 300, np.float32)
        return [torch.from_numpy(x).to(torch.bfloat16)]

    cases = [
        ("fused_arith (224,224,3) uint8 -> bfloat16", lambda *a: K.fused_arith(a[0], bf16_ops),
         lambda *a: K.fused_arith_plain(a[0], bf16_ops), lambda: [u8((IMAGE, IMAGE, 3))]),
        ("fused_arith (16000,1) bfloat16 -> float32",
         lambda *a: K.fused_arith(a[0], bf16_audio_ops),
         lambda *a: K.fused_arith_plain(a[0], bf16_audio_ops), bf16_window),
        ("fused_arith (224,224,3)", lambda *a: K.fused_arith(a[0], ops),
         lambda *a: K.fused_arith_plain(a[0], ops), lambda: [u8((IMAGE, IMAGE, 3))]),
        ("fused_arith (300,300,3)", lambda *a: K.fused_arith(a[0], ops),
         lambda *a: K.fused_arith_plain(a[0], ops), lambda: [u8((SSD_IMAGE, SSD_IMAGE, 3))]),
        ("fused_arith (16000,1) int16", lambda *a: K.fused_arith(a[0], audio_ops),
         lambda *a: K.fused_arith_plain(a[0], audio_ops),
         lambda: [torch.from_numpy(rng.integers(-32768, 32768, (AUDIO_WINDOW, 1))
                                   .astype(np.int16))]),
        ("int8_matmul (1,1280,1001) split-K", K.int8_matmul, K.int8_matmul_plain,
         matmul(1, 1280, CLASSES)),
        ("int8_matmul (17,1280,1001) tiled", K.int8_matmul, K.int8_matmul_plain,
         matmul(17, 1280, CLASSES)),
        ("nms_keep K=100 bit walk", N.pallas_nms_keep, N.nms_keep, boxes(100)),
        ("nms_keep K=1281 barrier walk", N.pallas_nms_keep, N.nms_keep, boxes(1281)),
        # above the static shared-memory limit: a cudaFuncSetAttribute per call
        ("nms_keep K=4096 barrier walk", N.pallas_nms_keep, N.nms_keep, boxes(4096)),
    ]
    names = []
    for name, kernel, plain, make in cases:
        static = [t.to(dev) for t in make()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel(*static)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kernel(*static)
        for _ in range(2):
            for s, t in zip(static, make()):
                s.copy_(t)
            graph.replay()
            want = plain(*static)
            torch.cuda.synchronize()
            if out.dtype == torch.float32 and "int8" in name:
                check(max_ulp(out, want) <= 1, f"{name} in a graph: more than 1 ulp off")
            else:
                check(bitwise_equal(torch, out, want),
                      f"{name} in a graph: not bitwise equal to its plain version")
        print(f"{name}: captured in a CUDA graph, two replays on new inputs equal to the "
              "plain version", flush=True)
        names.append(name)
    return names


# Host-issued device operations in a torch.profiler trace: kernel launches,
# copies, memsets and graph launches, as the runtime API calls that issue them.
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                 "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
                 "cudaMemsetAsync", "cudaMemset", "cudaGraphLaunch", "cuGraphLaunch")
# The device symbols of each wrapper's kernels.
KERNEL_SYMBOLS = {"fused_arith": ("fused_arith_kernel",),
                  "int8_matmul": ("int8_gemv_splitk_kernel", "int8_matmul_kernel"),
                  "pallas_nms_keep": ("nms_bits_kernel", "nms_walk_kernel")}


def trace(fn):
    """Run ``fn`` under torch.profiler (CUPTI): device busy ms, device
    activities, kernel records per wrapper (a graph's kernels included),
    and host-issued device operations by runtime call."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    records = {w: sum(any(s in e.name for s in syms) for e in device)
               for w, syms in KERNEL_SYMBOLS.items()}
    calls = collections.Counter(e.name for e in events
                                if e.device_type == DeviceType.CPU and e.name in RUNTIME_CALLS)
    # each graph launch, in launch order: its records of each wrapper's
    # kernels, and all its device records (a graph's nodes share the
    # correlation id of the launch that ran them)
    launches = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.name in ("cudaGraphLaunch", "cuGraphLaunch")),
                      key=lambda e: e.time_range.start)
    by_launch = collections.defaultdict(collections.Counter)
    names = collections.defaultdict(collections.Counter)
    total = collections.Counter(e.id for e in device)
    us_by_name = collections.Counter()
    count_by_name = collections.Counter()
    for e in device:
        names[e.id][e.name] += 1
        us_by_name[e.name] += e.device_time_total
        count_by_name[e.name] += 1
        for w, syms in KERNEL_SYMBOLS.items():
            if any(s in e.name for s in syms):
                by_launch[e.id][w] += 1
    return dict(busy_ms=sum(e.device_time_total for e in device) / 1e3,
                activities=len(device), records=records, calls=dict(calls),
                per_launch=[(dict(by_launch.get(e.id, {})), total[e.id]) for e in launches],
                names_per_launch=[dict(names.get(e.id, {})) for e in launches],
                us_by_name=dict(us_by_name), count_by_name=dict(count_by_name))


def run_pipeline(nns, desc, model, frames_expected, seg=None, during=None, got=None,
                 setup=None):
    """Build ``desc`` with parse_launch, set the filter's model (unless
    ``model`` is None: the string names it), run ``setup(p)`` if given, run
    it to EOS; ``during(p)`` runs after EOS while the pipeline still plays (its
    backend open).  The sink's frames arrive through ``connect("new-data",
    ...)`` (into ``got`` when given).  Returns (pipeline, sink arrival times,
    during's result)."""
    arrivals = []

    def on_frame(frame):
        arrivals.append(time.perf_counter())
        if got is not None:
            got.append(frame)

    p = nns.parse_launch(desc)
    if seg is not None:
        p.segment_compile = seg
    if model is not None:  # else the launch string names the model
        p["f"].model = model
    if setup is not None:
        setup(p)
    p["out"].connect("new-data", on_frame)
    p.start()
    try:
        check(p.wait(600), f"the pipeline did not finish within 600 s: {desc}")
        result = during(p) if during is not None else None
    finally:
        p.stop()
    check(len(arrivals) == frames_expected,
          f"the pipeline delivered {len(arrivals)} of {frames_expected} frames")
    return p, arrivals, result


def rates(arrivals, np, end=None):
    """Frames a second over the sink's arrivals, and the p50 and p90 gap.
    ``end``: the time the card finished the last frame (a synchronize after
    EOS), where nothing on the path reads the outputs back, so that the
    arrivals are only the host's enqueue."""
    gaps = np.diff(np.asarray(arrivals)) * 1e3
    last = arrivals[-1] if end is None else end
    return dict(fps=(len(arrivals) - 1) / (last - arrivals[0]),
                p50_ms=float(np.median(gaps)), p90_ms=float(np.percentile(gaps, 90)))


def host_ops(calls) -> int:
    return sum(calls.values())


def captured_against_eager(torch, be, xs, exact):
    """The filter's captured function against its eager call on the same
    frames, on the card; the replays' outputs must be distinct tensors.
    Returns the largest difference, absolute and relative to the largest
    output of its frame."""
    with torch.inference_mode():
        got = [be.invoke((x,)) for x in xs]
        want = [be.eager(x) for x in xs]
    torch.cuda.synchronize()
    ptrs = [o.data_ptr() for outs in got for o in outs]
    check(len(set(ptrs)) == len(ptrs), "replay outputs alias each other: no clone")
    err = rel = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            check(a.shape == b.shape and a.dtype == b.dtype, f"frame {i}: shape/dtype differ")
            if exact:
                check(bitwise_equal(torch, a, b), f"frame {i}: the replay differs from eager")
            if a.dtype.is_floating_point:
                d = float((a.double() - b.double()).abs().max())
                err = max(err, d)
                rel = max(rel, d / max(float(b.double().abs().max()), 1e-30))
    return err, rel


def loop_rates(torch, call, xs):
    """A frame loop over ``call`` and the decoder's one device→host read:
    fps over the frames, and the host-issued device operations and busy
    time per frame from a traced pass."""
    def once():
        with torch.inference_mode():
            for x in xs:
                call(x)[0].cpu()

    once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    once()
    fps = len(xs) / (time.perf_counter() - t0)
    tr = trace(once)
    return dict(fps=fps, host_ops_per_frame=host_ops(tr["calls"]) / len(xs),
                busy_ms_per_frame=tr["busy_ms"] / len(xs))


def traced_run(nns, desc, model, n, seg=None, tracers=(), setup=None):
    """One pipeline run of ``n`` frames traced from its first frame: the
    upload's lock holds the source until start() (negotiation, warm-up,
    capture) has returned and the profiler runs, so the window holds the
    ``n`` frames and nothing of the capture.  ``tracers`` (names of
    ``obs.TRACERS``) are attached before the start; ``setup(p)`` runs
    after the parse."""
    p = nns.parse_launch(desc)
    if seg is not None:
        p.segment_compile = seg
    if model is not None:
        p["f"].model = model
    if setup is not None:
        setup(p)
    for name in tracers:
        p.attach_tracer(name)
    delivered = []
    p["out"].connect("new-data", delivered.append)
    gate = p["u"]._lock
    gate.acquire()
    try:
        p.start()
    except BaseException:
        gate.release()
        raise
    try:
        # a launch in the trace's first moments may leave no record: the
        # first frame waits 0.25 s (idle card time, no busy time)
        tr = trace(lambda: (time.sleep(0.25), gate.release(),
                            check(p.wait(600), "traced run did not finish")))
    finally:
        p.stop()
    check(len(delivered) == n, f"traced run delivered {len(delivered)} of {n}")
    return tr


def launch_check(tr, kernels):
    """The per-frame launch check on one trace; returns the device records
    the tracer lost.  Each graph launch must hold at most one record of each
    path kernel and none of the others, and no path kernel may have a record
    outside a graph launch.  Every launch replays the same captured graph, so
    a launch holding fewer device records than the fullest one lost records
    in the tracer (CUPTI drops one now and then): such a launch may lack as
    many path-kernel records as it lost, no more.  A kernel missing from the
    graph, or launched twice in it, fails."""
    full = max(total for _, total in tr["per_launch"])
    lost = 0
    for i, (rec, total) in enumerate(tr["per_launch"]):
        extra = {k: n for k, n in rec.items() if n > (1 if k in kernels else 0)}
        check(not extra, f"graph launch {i} holds {extra} kernel records: a kernel launched "
                         "more than once per frame, or off the path")
        missing = [k for k in kernels if not rec.get(k)]
        check(len(missing) <= full - total,
              f"graph launch {i} holds no record of {missing}, yet {total} of the fullest "
              f"launch's {full} device records: a path kernel not launched from the graph")
        lost += full - total
    for k in kernels:
        in_graph = sum(rec.get(k, 0) for rec, _ in tr["per_launch"])
        check(tr["records"][k] == in_graph,
              f"{k}: {tr['records'][k] - in_graph} records outside the graph launches")
    return lost


def profile_path(run, res, kernels):
    """Device busy time, idle share and host-issued operations per frame
    from a traced run of PROFILED frames, and the per-frame launch check:
    PROFILED graph launches, each holding one record of each of the path's
    kernels and none of the other kernels.  A trace that misses the mark is
    taken again, three times in all; the last one must then pass
    ``launch_check``, which allows a launch to lack a record only where the
    tracer demonstrably lost that launch's records.  Returns the trace."""
    want = {k: PROFILED if k in kernels else 0 for k in KERNEL_SYMBOLS}
    for attempt in range(3):
        tr = run(PROFILED)
        launches = tr["calls"].get("cudaGraphLaunch", 0) + tr["calls"].get("cuGraphLaunch", 0)
        if tr["records"] == want and launches == PROFILED:
            break
        odd = {i: pl for i, pl in enumerate(tr["per_launch"]) if pl != tr["per_launch"][-1]}
        print(f"  trace of {PROFILED} frames: kernel records {tr['records']}, {launches} graph "
              f"launches (attempt {attempt + 1}); launches unlike the last "
              f"{tr['per_launch'][-1]}: {odd}", flush=True)
    check(any(tr["records"][k] for k in kernels),
          "the CUPTI trace holds no record of a kernel launched from a graph: the per-frame "
          "launch check cannot be made")
    check(launches == PROFILED and len(tr["per_launch"]) == PROFILED,
          f"{launches} graph launches for {PROFILED} frames")
    lost = launch_check(tr, kernels)
    print(f"  per-frame launch check: {tr['records']} kernel records over {PROFILED} graph "
          f"launches of {max(t for _, t in tr['per_launch'])} device records each; "
          f"{lost} lost by the tracer", flush=True)
    busy = tr["busy_ms"] / PROFILED
    res.update(kernel_records=tr["records"], records_lost_by_tracer=lost,
               device_busy_ms_per_frame=busy, device_idle_share=1 - busy * res["fps"] / 1e3,
               device_activities_per_frame=tr["activities"] / PROFILED,
               host_ops_per_frame=host_ops(tr["calls"]) / PROFILED,
               host_calls_per_frame={k: v / PROFILED for k, v in tr["calls"].items()})
    return tr


def report_path(name, res, card):
    print(f"{name}: {res['frames']} frames through parse_launch, one capture, "
          f"{res['replays']} replays [{card}]", flush=True)
    for key, label in (("fps", "fps"), ("p50_ms", "p50 ms/frame"), ("p90_ms", "p90 ms/frame"),
                       ("device_busy_ms_per_frame", "device busy ms/frame"),
                       ("device_idle_share", "device idle share"),
                       ("device_activities_per_frame", "device activities/frame"),
                       ("host_ops_per_frame", "host-issued device operations/frame"),
                       ("capture_s", "capture wall s"), ("warmup_s", "pre-capture warm-up s"),
                       ("eager_fps", "eager loop fps"),
                       ("eager_host_ops_per_frame", "eager loop host-issued operations/frame"),
                       ("replay_fps", "replay loop fps"),
                       ("replay_host_ops_per_frame", "replay loop host-issued operations/frame")):
        if key in res:
            print(f"  {name} {label}: {res[key]} [{card}]", flush=True)


def slice_phase(torch, np, K, ops, root, card, keep):
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.ops.quant import quantize_activations

    t0 = time.perf_counter()
    model = mobilenet_v2.build_quantized(num_classes=CLASSES, width_mult=1.0, image_size=IMAGE,
                                         int8_head=True, seed=0, device="cuda")
    print(f"model built in {time.perf_counter() - t0:.3f} s", flush=True)
    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    labels_path = os.path.join(work, "labels_1001.txt")
    labels = [f"class_{i}" for i in range(CLASSES)]
    with open(labels_path, "w", encoding="utf-8") as f:
        f.write("\n".join(labels))

    def desc(n):
        return (f"videotestsrc name=src num-buffers={n} width={IMAGE} height={IMAGE} "
                "pattern=random seed=7 ! tensor_converter name=conv ! "
                f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
                "tensor_upload name=u ! queue max-size-buffers=16 ! "
                "tensor_filter framework=torch name=f ! "
                f"tensor_decoder mode=image_labeling option1={labels_path} ! "
                "tensor_sink name=out collect=true")

    state = {}

    def during(p):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     transform_folded=not any(type(n).__name__ == "TensorTransform"
                                              for n in p.nodes.values()))
        src = p["src"]
        xs = [torch.from_numpy(src._make_frame(i)) for i in range(8)]
        state["logit_abs_diff"], state["logit_rel_diff"] = captured_against_eager(
            torch, be, xs, exact=False)
        frames = [torch.from_numpy(src._make_frame(i)) for i in range(PROFILED)]
        state["eager"] = loop_rates(torch, be.eager, frames)
        state["replay"] = loop_rates(torch, lambda x: be.invoke((x,)), frames)
        return p

    run_pipeline(nns, desc(WARMUP_FRAMES), model, WARMUP_FRAMES)  # CUDA context, cuDNN plans
    K.reset_launches()
    p, arrivals, _ = run_pipeline(nns, desc(FRAMES), model, FRAMES, during=during)
    frames = p["out"].frames
    stats, launches = state["stats"], state["launches"]
    print(f"image-labeling path over {FRAMES} frames: backend {stats}, wrapper launches "
          f"{launches}", flush=True)
    check(state["transform_folded"], "the normalize did not fold across upload and queue")
    check(stats["captures"] == 1 and stats["replays"] == FRAMES,
          f"expected one capture and {FRAMES} replays: {stats}")
    for name in ("fused_arith", "int8_matmul"):
        check(launches[name] == stats["warmup_calls"] + 1,
              f"{name}: {launches[name]} wrapper launches, expected the "
              f"{stats['warmup_calls']} warm-up calls and the capture")
    check(len({id(f) for f in frames}) == FRAMES, "the sink holds one frame object twice")

    # The replay against the eager call of the same wrapped function.
    diff = state["logit_abs_diff"]
    if diff == 0.0:
        print("captured against eager: logits bitwise equal on 8 frames", flush=True)
    else:
        # A conv algorithm picked differently in capture and in eager: the
        # plain-run bound applies.
        print(f"captured against eager: logits differ by up to {diff} (absolute), "
              f"{state['logit_rel_diff']} relative to the largest logit", flush=True)
        check(state["logit_rel_diff"] <= 1e-3, "the replay's logits differ from eager by more "
                                               "than 1e-3 (relative)")

    # The same model with the kernels' plain versions, on the card.
    head = model.params["classifier"]
    src = p["src"]
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
    # allowed: 1e-3 relative, for a conv algorithm picked differently from
    # one call to the next
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

    res = dict(frames=FRAMES, replays=stats["replays"], **rates(arrivals, np),
               distinct_labels=len(set(got_idx)), top_logit_rel_err=top_err,
               logit_rel_err=logit_err, captured_vs_eager_abs=diff,
               capture_s=stats["capture_s"], warmup_s=stats["warmup_s"],
               eager_fps=state["eager"]["fps"],
               eager_host_ops_per_frame=state["eager"]["host_ops_per_frame"],
               eager_busy_ms_per_frame=state["eager"]["busy_ms_per_frame"],
               replay_fps=state["replay"]["fps"],
               replay_host_ops_per_frame=state["replay"]["host_ops_per_frame"],
               replay_busy_ms_per_frame=state["replay"]["busy_ms_per_frame"])
    print(f"slice: labels equal to the plain run ({len(set(got_idx))} distinct), logits within "
          f"{logit_err:.3g} (relative)", flush=True)

    profile_path(lambda n: traced_run(nns, desc(n), model, n), res,
                 ("fused_arith", "int8_matmul"))
    report_path("image labeling", res, card)
    keep["image_labeling"] = (desc, model, None, ("fused_arith", "int8_matmul"))
    return launches, res


def _objects(frame):
    return [(o.class_id, o.x, o.y, o.width, o.height) for o in frame.meta["objects"]]


def detection_phase(torch, np, K, ops, root, card, keep):
    """Slice 2: the object-detection pipeline at full width, with
    whole-segment compilation and the NMS kernel; then its fused-decode
    variant."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.decoders import bounding_boxes as bb
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

    def desc(n, submode):
        return (f"videotestsrc name=src num-buffers={n} width={SSD_IMAGE} height={SSD_IMAGE} "
                "pattern=random seed=11 ! tensor_converter name=conv ! "
                f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
                "tensor_upload name=u ! queue max-size-buffers=16 ! "
                "tensor_filter framework=torch name=f ! "
                f"tensor_decoder name=dec mode=bounding_boxes option1={submode} "
                f"option2={labels} option3={priors_path} option4={wh} option5={wh} ! "
                "tensor_sink name=out collect=true")

    state = {}

    def during(p):
        be = p["f"].backend
        types = {type(n).__name__ for n in p.nodes.values()}
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     converter_folded="TensorConverter" not in types,
                     transform_folded="TensorTransform" not in types,
                     decoder_lowered=p["dec"].plugin._lowered is not None,
                     label=be.segment_label, fn=be._fn)
        src = p["src"]
        xs = [torch.from_numpy(src._make_frame(i)) for i in range(8)]
        captured_against_eager(torch, be, xs, exact=True)
        frames = [torch.from_numpy(src._make_frame(i)) for i in range(PROFILED)]
        state["eager"] = loop_rates(torch, be.eager, frames)
        state["replay"] = loop_rates(torch, lambda x: be.invoke((x,)), frames)
        return p

    run_pipeline(nns, desc(WARMUP_FRAMES, "tflite-ssd"), model, WARMUP_FRAMES, seg=True)
    K.reset_launches()
    p, arrivals, _ = run_pipeline(nns, desc(FRAMES, "tflite-ssd"), model, FRAMES, seg=True,
                                  during=during)
    frames, src = p["out"].frames, p["src"]
    stats, launches = state["stats"], state["launches"]
    fused_fn = state.pop("fn")
    print(f"object-detection path over {FRAMES} frames: backend {stats}, wrapper launches "
          f"{launches}; segment {state['label']}", flush=True)
    check(state["converter_folded"] and state["transform_folded"] and state["decoder_lowered"],
          f"the segment did not fold the converter, transform and decoder: "
          f"{ {k: state[k] for k in ('converter_folded', 'transform_folded', 'decoder_lowered')} }")
    check(stats["captures"] == 1 and stats["replays"] == FRAMES,
          f"expected one capture and {FRAMES} replays: {stats}")
    for name in ("fused_arith", "pallas_nms_keep"):
        check(launches[name] == stats["warmup_calls"] + 1,
              f"{name}: {launches[name]} wrapper launches, expected the "
              f"{stats['warmup_calls']} warm-up calls and the capture")
    check(len({id(f) for f in frames}) == FRAMES, "the sink holds one frame object twice")
    print("captured against eager: detections bitwise equal on 8 frames", flush=True)
    res = dict(frames=FRAMES, replays=stats["replays"], **rates(arrivals, np),
               segment=state["label"], capture_s=stats["capture_s"],
               warmup_s=stats["warmup_s"], eager_fps=state["eager"]["fps"],
               eager_host_ops_per_frame=state["eager"]["host_ops_per_frame"],
               eager_busy_ms_per_frame=state["eager"]["busy_ms_per_frame"],
               replay_fps=state["replay"]["fps"],
               replay_host_ops_per_frame=state["replay"]["host_ops_per_frame"],
               replay_busy_ms_per_frame=state["replay"]["busy_ms_per_frame"])

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
    hp, host_arrivals, _ = run_pipeline(nns, desc(FRAMES, "tflite-ssd"), model, FRAMES,
                                        seg=False)
    check(hp["dec"].plugin._lowered is None, "segments off, yet the decoder was lowered")
    host = hp["out"].frames
    hr = rates(host_arrivals, np)
    res.update(host_fps=hr["fps"], host_p50_ms=hr["p50_ms"])
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
    print(f"object detection: {n_objects} detections equal to the host decode (prob within "
          f"{prob_err:.3g}; segments off: {res['host_fps']} fps); NMS kept {kept} of "
          f"{candidates} candidates in 4 frames; largest candidate area {max_area} px",
          flush=True)

    profile_path(lambda n: traced_run(nns, desc(n, "tflite-ssd"), model, n, seg=True), res,
                 ("fused_arith", "pallas_nms_keep"))
    report_path("object detection", res, card)
    keep["object_detection"] = (lambda n: desc(n, "tflite-ssd"), model, True,
                                ("fused_arith", "pallas_nms_keep"))

    # The fused-decode variant: decode_topk in the model, fused-ssd decoder.
    K.reset_launches()
    fp, _, fused_lowered = run_pipeline(
        nns, desc(FUSED_FRAMES, "fused-ssd"), fused_model, FUSED_FRAMES, seg=True,
        during=lambda p: p["dec"].plugin._lowered is not None)
    fused_nms = {k.__name__: k.launches for k in K.KERNELS}["pallas_nms_keep"]
    fused_stats = fp["f"].backend.stats
    off, _, _ = run_pipeline(nns, desc(FUSED_FRAMES, "fused-ssd"), fused_model, FUSED_FRAMES,
                             seg=False)
    check(fused_lowered and fused_stats["captures"] == 1
          and fused_stats["replays"] == FUSED_FRAMES
          and fused_nms == fused_stats["warmup_calls"] + 1,
          f"fused-ssd: lowered {fused_lowered}, backend {fused_stats}, "
          f"{fused_nms} nms_keep launches")
    fused_objects = 0
    for i, (a, b) in enumerate(zip(fp["out"].frames, off["out"].frames)):
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


OBS_TRACERS = ("latency", "stats", "drops", "copies", "spans")


def span_split(records, frames):
    """Where a frame's host time goes, from the span records (ms a frame).
    Per element: its dispatch span (which holds the dispatches of the
    elements after it on the same thread: a pad push runs them inside it)
    and its own time, the span less the dispatch spans nested in it.  Per
    thread: the period between its frames (from the starts of its outermost
    dispatch spans) and the part of it inside them; the rest is the
    thread's own work outside every element (a source making its frame) or
    its wait for the next one (a queue's worker)."""
    import collections

    dispatch = [r for r in records if r[0] == "X" and r[5] == "dispatch"]
    ids = {r[7] for r in dispatch}
    nested = collections.Counter()
    for r in dispatch:
        nested[r[8]] += r[2]
    elements, outer = {}, collections.defaultdict(list)
    for r in dispatch:
        e = elements.setdefault(r[4], {"thread": r[3], "span_ms": 0.0, "self_ms": 0.0})
        e["span_ms"] += r[2] / 1e6 / frames
        e["self_ms"] += (r[2] - nested[r[7]]) / 1e6 / frames
        if r[8] not in ids:
            outer[r[3]].append(r)
    threads = {}
    for tid, top in outer.items():
        top.sort(key=lambda r: r[1])
        period = (top[-1][1] - top[0][1]) / (len(top) - 1) / 1e6 if len(top) > 1 else 0.0
        threads[tid] = {"period_ms": period,
                        "in_elements_ms": sum(r[2] for r in top) / len(top) / 1e6}
    return elements, threads


def scraped_latency_count(text, pipeline):
    """The e2e latency histogram's count for ``pipeline`` in a /metrics
    scrape (None when the series is missing)."""
    import re

    m = re.search(r'^nnstpu_e2e_latency_ms_count\{pipeline="%s",src="[^"]*",sink="[^"]*"\} '
                  r"(\d+)$" % re.escape(pipeline), text, re.M)
    return int(m.group(1)) if m else None


def obs_checks(delivered, latency, scraped, host_ops, invoke_p50_ms, busy_ms):
    """The obs phase's checks on one path: every frame delivered is in the
    latency tracer and in the scraped histogram; with the tracers attached
    the host still issues 5 device operations a frame (CUPTI may lose the
    record of a runtime call now and then, as it did in a run without
    tracers: 79 for 16 frames; it never adds one, so a tracer's operation
    would show above 5); the profiled invoke (which waits for its outputs)
    lasts at least 0.9 of the device's busy time a frame."""
    check(latency == delivered and scraped == delivered,
          f"{delivered} frames delivered, the latency tracer saw {latency}, the scraped "
          f"histogram counts {scraped}")
    check(4.5 <= host_ops <= 5, f"{host_ops} host-issued device operations a frame with the "
                                "tracers attached, not 5")
    check(invoke_p50_ms >= 0.9 * busy_ms,
          f"profiled invoke p50 {invoke_p50_ms} ms is below 0.9 of the device's busy "
          f"{busy_ms} ms a frame: the filter did not wait for its outputs")


def obs_phase(torch, np, slices, root, card):
    """Slices 1 and 2 with every tracer attached and a scrape endpoint up:
    latency, the per-element split from the spans, host copies and drops,
    a scrape of /metrics and /stats.json, the Chrome trace written and read
    back; then a traced run with the tracers and profiling on, held to 5
    host-issued operations a frame, one record of each path kernel per
    graph launch, and a profiled invoke that covers the device's work."""
    import urllib.request

    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.obs import REGISTRY, MetricsServer, spans
    from nnstreamer_tpu_torch.utils import profiling

    work = os.path.join(root, "build", "chip_smoke")
    out = {}
    server = MetricsServer(port=0).start()
    try:
        for path, (desc, model, seg, kernels) in slices.items():
            _, plain_arrivals, _ = run_pipeline(nns, desc(FRAMES), model, FRAMES, seg=seg)
            REGISTRY.reset()
            spans.reset()
            p = nns.parse_launch(desc(FRAMES))
            p.name = f"obs_{path}"
            if seg is not None:
                p.segment_compile = seg
            p["f"].model = model
            for name in OBS_TRACERS:
                p.attach_tracer(name)
            arrivals = []
            p["out"].connect("new-data", lambda frame: arrivals.append(time.perf_counter()))
            p.start()
            try:
                check(p.wait(600), f"obs {path}: the pipeline did not finish")
                stats = p.stats()["tracers"]
                records = p.flight_snapshot()
                base = server.url[: -len("/metrics")]
                with urllib.request.urlopen(server.url, timeout=30) as resp:
                    scrape = resp.read().decode("utf-8")
                with urllib.request.urlopen(base + "/stats.json", timeout=30) as resp:
                    served = json.loads(resp.read())
            finally:
                p.stop()
            check(p.name in served and "latency" in served[p.name].get("tracers", {}),
                  f"obs {path}: /stats.json lacks the pipeline's tracers: {sorted(served)}")
            (latency,) = stats["latency"].values()
            copies, drops = stats["copies"], stats["drops"]
            split, threads = span_split(records, FRAMES)
            trace_path = os.path.join(work, f"obs_{path}.trace.json")
            with open(trace_path, "w", encoding="utf-8") as f:
                json.dump(spans.chrome_trace(records, process_name=p.name), f)
            with open(trace_path, encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
            named = {e["name"] for e in events if e["ph"] == "X"}
            check(set(split) <= named and {"s", "f"} <= {e["ph"] for e in events},
                  f"obs {path}: the Chrome trace lacks spans or flows: {sorted(named)}")
            res = dict(frames=len(arrivals), fps=rates(arrivals, np)["fps"],
                       fps_without_tracers=rates(plain_arrivals, np)["fps"],
                       latency_ms={k: latency[k] for k in ("p50_ms", "p90_ms", "p99_ms",
                                                             "mean_ms", "max_ms")},
                       elements=split, threads=threads, copies_per_frame=sum(
                           e["copies"] for e in copies["elements"].values()) / FRAMES,
                       copy_bytes_per_frame=copies["bytes_per_frame"], drops=drops,
                       spans=stats["spans"], chrome_trace_events=len(events))
            last = {}

            def profiled_run(n, desc=desc, model=model, seg=seg):
                profiling.reset()
                with profiling.profiled():
                    tr = traced_run(nns, desc(n), model, n, seg=seg, tracers=OBS_TRACERS)
                last.update(profiling.stats()["f"])
                return tr

            profile_path(profiled_run, res, kernels)
            res["invoke_ms"] = {k: last[k] for k in ("p50_ms", "p90_ms", "mean_ms", "count")}
            obs_checks(len(arrivals), latency["count"], scraped_latency_count(scrape, p.name),
                       res["host_ops_per_frame"], last["p50_ms"],
                       res["device_busy_ms_per_frame"])
            # the upload stages each host frame once (the JAX package would not)
            check(res["copies_per_frame"] == 1, f"obs {path}: {res['copies_per_frame']} host "
                                                "copies a frame, not the upload's one")
            profiling.reset()
            print(f"obs {path} [{card}]: {res['frames']} frames, {res['fps']} fps with the "
                  f"tracers, {res['fps_without_tracers']} without; source->sink latency p50 "
                  f"{latency['p50_ms']} ms, p90 {latency['p90_ms']} ms, p99 "
                  f"{latency['p99_ms']} ms; host copies a frame {res['copies_per_frame']} "
                  f"({copies['bytes_per_frame']} B); drops {drops or 'none'}", flush=True)
            for name, e in split.items():
                print(f"  obs {path} {name} [{e['thread']}]: dispatch span {e['span_ms']} "
                      f"ms a frame, own {e['self_ms']} ms", flush=True)
            for tid, t in threads.items():
                print(f"  obs {path} thread {tid}: a frame every {t['period_ms']} ms, "
                      f"{t['in_elements_ms']} ms of it inside the elements", flush=True)
            print(f"  obs {path}: profiled invoke p50 {last['p50_ms']} ms against "
                  f"{res['device_busy_ms_per_frame']} ms device busy a frame; "
                  f"{res['host_ops_per_frame']} host-issued operations a frame with the "
                  f"tracers; Chrome trace {trace_path} ({len(events)} events)", flush=True)
            out[path] = res
    finally:
        server.stop()
    return out


def audio_checks(stats, launches, got_idx, eager_idx, replay_logits, cpu_logits):
    """The audio phase's checks on what it measured: one capture and a
    replay per window, ``fused_arith`` called only in the warm-up and the
    capture and the other kernels never, the labels equal to the eager
    call's, and the replayed logits within AUDIO_LOGIT_REL of the largest
    CPU logit with equal top-1 labels.  Returns the largest logit
    difference relative to the largest logit."""
    frames = len(got_idx)
    check(stats["captures"] == 1 and stats["replays"] == frames,
          f"expected one capture and {frames} replays: {stats}")
    check(launches["fused_arith"] == stats["warmup_calls"] + 1,
          f"fused_arith: {launches['fused_arith']} wrapper launches, expected the "
          f"{stats['warmup_calls']} warm-up calls and the capture")
    check(launches["int8_matmul"] == 0 and launches["pallas_nms_keep"] == 0,
          f"the audio path launched a kernel off its path: {launches}")
    check(got_idx == eager_idx, f"labels differ from the eager run: {got_idx} vs {eager_idx}")
    rel = 0.0
    for i, (g, w) in enumerate(zip(replay_logits, cpu_logits)):
        check(g.shape == w.shape == (AUDIO_CLASSES,), f"window {i}: logits of shape {g.shape}")
        scale = max(float(abs(w).max()), 1e-30)
        rel = max(rel, float(abs(g - w).max()) / scale)
        check(int(g.argmax()) == int(w.argmax()),
              f"window {i}: top-1 {int(g.argmax())} on the card, {int(w.argmax())} on the CPU")
    check(rel <= AUDIO_LOGIT_REL, f"logits differ from the CPU run by {rel} of the largest "
                                  f"logit (allowed {AUDIO_LOGIT_REL})")
    return rel


def audio_phase(torch, np, K, ops, root, card):
    """The audio path at full width from its launch string: 64 one-second
    windows, the normalize folded into the filter's captured graph."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.elements.testsrc import AudioTestSrc
    from nnstreamer_tpu_torch.models import audio_cnn

    t0 = time.perf_counter()
    kw = dict(num_classes=AUDIO_CLASSES, window=AUDIO_WINDOW, channels=(32, 64, 64), seed=0)
    model = audio_cnn.build(device="cuda", **kw)
    cpu_model = audio_cnn.build(device="cpu", **kw)
    print(f"audio model built in {time.perf_counter() - t0:.3f} s", flush=True)
    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    labels_path = os.path.join(work, "labels_12.txt")
    labels = [f"word_{i}" for i in range(AUDIO_CLASSES)]
    with open(labels_path, "w", encoding="utf-8") as f:
        f.write("\n".join(labels))
    per = AUDIO_WINDOW // AUDIO_BLOCK

    def desc(n):
        return (f"audiotestsrc name=src num-buffers={n * per} samplesperbuffer={AUDIO_BLOCK} "
                f"rate={AUDIO_RATE} freq=440 ! tensor_converter ! "
                f"tensor_aggregator frames-out={per} frames-dim=1 ! "
                f"tensor_transform mode=arithmetic option={AUDIO_NORMALIZE} acceleration=pallas ! "
                "tensor_upload name=u ! queue max-size-buffers=16 ! "
                "tensor_filter framework=torch name=f ! "
                f"tensor_decoder mode=image_labeling option1={labels_path} ! tensor_sink name=out")

    src = AudioTestSrc(samplesperbuffer=AUDIO_BLOCK, rate=AUDIO_RATE, freq=440)
    windows = [torch.from_numpy(np.concatenate([src._make_block(i * per + j) for j in range(per)]))
               for i in range(FRAMES)]
    state = {}

    def during(p):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     transform_folded=not any(type(n).__name__ == "TensorTransform"
                                              for n in p.nodes.values()))
        state["abs_diff"], state["rel_diff"] = captured_against_eager(torch, be, windows[:8],
                                                                      exact=False)
        with torch.inference_mode():
            state["eager_idx"] = [int(torch.argmax(be.eager(x)[0])) for x in windows]
            state["replay_logits"] = [be.invoke((x,))[0].cpu().numpy() for x in windows[:8]]
        state["eager"] = loop_rates(torch, be.eager, windows[:PROFILED])
        state["replay"] = loop_rates(torch, lambda x: be.invoke((x,)), windows[:PROFILED])
        return p

    run_pipeline(nns, desc(WARMUP_FRAMES), model, WARMUP_FRAMES)
    K.reset_launches()
    frames = []
    p, arrivals, _ = run_pipeline(nns, desc(FRAMES), model, FRAMES, during=during, got=frames)
    stats, launches = state["stats"], state["launches"]
    print(f"audio path over {FRAMES} windows: backend {stats}, wrapper launches {launches}",
          flush=True)
    check(state["transform_folded"], "the audio normalize did not fold across upload and queue")
    with torch.inference_mode():
        cpu_logits = [cpu_model(K.fused_arith(x, ops)).numpy() for x in windows[:8]]
    got_idx = [f.meta["label_index"] for f in frames]
    rel = audio_checks(stats, launches, got_idx, state["eager_idx"], state["replay_logits"],
                       cpu_logits)
    check([f.meta["label"] for f in frames] == [labels[i] for i in got_idx],
          "label text does not match the label index")
    print(f"audio: labels equal to the eager run ({len(set(got_idx))} distinct), logits within "
          f"{rel:.3g} of the largest CPU logit (allowed {AUDIO_LOGIT_REL}); replay against "
          f"eager {state['abs_diff']} (absolute)", flush=True)
    res = dict(frames=FRAMES, replays=stats["replays"], **rates(arrivals, np),
               distinct_labels=len(set(got_idx)), logit_rel_err_vs_cpu=rel,
               captured_vs_eager_abs=state["abs_diff"], capture_s=stats["capture_s"],
               warmup_s=stats["warmup_s"], eager_fps=state["eager"]["fps"],
               eager_host_ops_per_frame=state["eager"]["host_ops_per_frame"],
               eager_busy_ms_per_frame=state["eager"]["busy_ms_per_frame"],
               replay_fps=state["replay"]["fps"],
               replay_host_ops_per_frame=state["replay"]["host_ops_per_frame"],
               replay_busy_ms_per_frame=state["replay"]["busy_ms_per_frame"])
    profile_path(lambda n: traced_run(nns, desc(n), model, n), res, ("fused_arith",))
    report_path("audio", res, card)
    return launches, res


def model_file_phase(torch, np, K, ops, root, card):
    """Slice 7's path at full width from its launch string alone: camera
    frames through the scaler custom filter (``custom-python``, the port's
    example), the normalize, and MobileNet-v2 1.0 built from a checkpoint
    that the port's ``save_state`` wrote in the JAX package's layout
    (``model=<file>.npz custom=builder=mobilenet_v2:build_quantized,...``).
    No Python object is put on any element."""
    import importlib.util

    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    tree = mobilenet_v2.init_tree(0, CLASSES, 1.0)
    ckpt = os.path.join(work, "mobilenet_v2.npz")
    save_state(tree, ckpt)
    save_s = time.perf_counter() - t0
    print(f"MobileNet-v2 1.0 seed-0 params written to {os.path.relpath(ckpt, root)} "
          f"({os.path.getsize(ckpt)} bytes) in {save_s:.3f} s", flush=True)
    labels_path = os.path.join(work, "labels_1001.txt")
    labels = [f"class_{i}" for i in range(CLASSES)]
    with open(labels_path, "w", encoding="utf-8") as f:
        f.write("\n".join(labels))
    scaler = os.path.join(root, "nnstreamer_tpu_torch", "examples", "custom_filters", "scaler.py")

    def desc(n):
        return (f"videotestsrc name=src num-buffers={n} width={CAMERA[1]} height={CAMERA[0]} "
                "pattern=random seed=7 ! tensor_converter ! "
                f"tensor_filter framework=custom-python model={scaler} custom={IMAGE}x{IMAGE} ! "
                f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
                "tensor_upload name=u ! queue max-size-buffers=16 ! "
                f"tensor_filter framework=torch name=f model={ckpt} "
                "custom=builder=mobilenet_v2:build_quantized,int8_head=1 ! "
                f"tensor_decoder mode=image_labeling option1={labels_path} ! tensor_sink name=out")

    state = {}

    def during(p):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     transform_folded=not any(type(n).__name__ == "TensorTransform"
                                              for n in p.nodes.values()),
                     model=be.model.name, device=str(be.device))
        return p

    run_pipeline(nns, desc(WARMUP_FRAMES), None, WARMUP_FRAMES)
    K.reset_launches()
    got = []
    p, arrivals, _ = run_pipeline(nns, desc(FRAMES), None, FRAMES, during=during, got=got)
    stats, launches = state["stats"], state["launches"]
    print(f"model-file path over {FRAMES} frames: {state['model']} on {state['device']}, "
          f"backend {stats}, wrapper launches {launches}", flush=True)
    check(state["transform_folded"], "the normalize did not fold into the filter")
    check(stats["captures"] == 1 and stats["replays"] == FRAMES,
          f"expected one capture and {FRAMES} replays: {stats}")
    for name in ("fused_arith", "int8_matmul"):
        check(launches[name] == stats["warmup_calls"] + 1,
              f"{name}: {launches[name]} wrapper launches, expected the "
              f"{stats['warmup_calls']} warm-up calls and the capture")
    check(launches["pallas_nms_keep"] == 0, f"nms_keep launched on the model-file path")

    # The builder called directly on the same tree and the same scaled frames.
    spec = importlib.util.spec_from_file_location("chip_smoke_scaler", scaler)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    resize = mod.CustomFilter(f"{IMAGE}x{IMAGE}")
    direct = mobilenet_v2.build_quantized(params=tree, int8_head=True, device="cuda")
    src = p["src"]
    want_idx, want_top = [], []
    with torch.inference_mode():
        for i in range(FRAMES):
            x = resize.invoke(torch.from_numpy(src._make_frame(i))).cuda()
            check(tuple(x.shape) == (IMAGE, IMAGE, 3), f"scaled frame {tuple(x.shape)}")
            logits = direct(K.fused_arith(x, ops))
            check(bool(torch.isfinite(logits).all()) and logits.shape == (CLASSES,),
                  f"frame {i}: direct logits not finite / wrong shape")
            want_idx.append(int(torch.argmax(logits)))
            want_top.append(float(logits.max()))
    got_idx = [f.meta["label_index"] for f in got]
    check(got_idx == want_idx, f"labels differ from the direct build: {got_idx} vs {want_idx}")
    check([f.meta["label"] for f in got] == [labels[i] for i in want_idx],
          "label text does not match the label index")
    # allowed: 1e-3 relative, a conv algorithm picked differently
    top_err = max(abs(f.meta["score"] - t) / max(1.0, abs(t)) for f, t in zip(got, want_top))
    check(top_err <= 1e-3, f"top logits differ from the direct build by {top_err} (relative)")
    res = dict(frames=FRAMES, replays=stats["replays"], **rates(arrivals, np),
               distinct_labels=len(set(got_idx)), top_logit_rel_err=top_err,
               checkpoint_bytes=os.path.getsize(ckpt), save_s=save_s,
               capture_s=stats["capture_s"], warmup_s=stats["warmup_s"])
    print(f"model file: labels equal to the direct build ({len(set(got_idx))} distinct), top "
          f"logits within {top_err:.3g} (relative)", flush=True)
    profile_path(lambda n: traced_run(nns, desc(n), None, n), res,
                 ("fused_arith", "int8_matmul"))
    report_path("model file", res, card)
    return launches, res


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if hasattr(tree, "data_ptr") else []


def torchscript_phase(torch, np, K, ops, root):
    """A TorchScript file (MobileNet-v2 1.0, bf16 compute, traced on the
    card) named in slice 1's string: one capture, and the replays' logits
    within 1e-3 relative of the traced module's eager call."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.models import mobilenet_v2

    model = mobilenet_v2.build(num_classes=CLASSES, image_size=IMAGE, seed=0, device="cuda")

    class Net(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m
            for i, t in enumerate(_tensor_leaves(m.params)):  # the tracer's module state
                self.register_buffer(f"p{i}", t)

        def forward(self, x):
            return self.m(x)

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "mobilenet_v2_bf16.pt")
    t0 = time.perf_counter()
    with torch.no_grad(), warnings.catch_warnings():
        # the padding arithmetic of the convs is traced as constants: the
        # file serves the traced geometry, which is the stream's
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        traced = torch.jit.trace(Net(model).eval(), torch.zeros(IMAGE, IMAGE, 3, device=model.device),
                                 check_trace=False)
    traced.save(path)
    trace_s = time.perf_counter() - t0
    desc = (f"videotestsrc name=src num-buffers={TS_FRAMES} width={IMAGE} height={IMAGE} "
            "pattern=random seed=7 ! tensor_converter ! "
            f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
            "tensor_upload name=u ! queue max-size-buffers=16 ! "
            f"tensor_filter framework=torch name=f model={path} ! tensor_sink name=out")
    state = {}

    def during(p):
        be = p["f"].backend
        src = p["src"]
        state.update(stats=dict(be.stats), scripted=isinstance(be.model.apply,
                                                                torch.jit.ScriptModule))
        xs = [torch.from_numpy(src._make_frame(i)) for i in range(8)]
        state["abs"], state["rel"] = captured_against_eager(torch, be, xs, exact=False)
        return p

    got = []
    run_pipeline(nns, desc, None, TS_FRAMES, during=during, got=got)
    stats = state["stats"]
    check(state["scripted"], "the filter did not load a TorchScript module")
    check(stats["captures"] == 1 and stats["replays"] == TS_FRAMES,
          f"TorchScript: expected one capture and {TS_FRAMES} replays: {stats}")
    check(all(tuple(f.tensor(0).shape) == (CLASSES,) and bool(torch.isfinite(f.tensor(0)).all())
              for f in got), "TorchScript logits not finite / wrong shape")
    check(state["rel"] <= 1e-3, f"TorchScript: replays differ from the traced module's eager "
                                f"call by {state['rel']} (relative)")
    res = dict(frames=TS_FRAMES, replays=stats["replays"], trace_s=trace_s,
               file_bytes=os.path.getsize(path), replay_vs_eager_abs=state["abs"],
               replay_vs_eager_rel=state["rel"])
    print(f"TorchScript: {TS_FRAMES} frames through {os.path.relpath(path, root)}, one capture, "
          f"replays within {state['rel']:.3g} of the eager call (relative)", flush=True)
    return res


def drift_phase(torch, np, K, ops, bind):
    """C3 on the card: frames whose shape or dtype drifts with no caps event
    (the pads upstream of the filter pass frames unchecked, as a
    polymorphic pad does).  The filter, with the normalize folded in,
    rebinds through its drift hook and captures while the pipeline plays,
    the upload's copies going on on the source's thread: (224,224,3) uint8,
    (300,300,3), (224,224,3) again (an LRU hit), then an int16 frame.  The
    upload's stream is held before each copy, as the upload-wait phase
    holds it, so a capture taken while PLAYING meets copies in flight: it
    synchronizes the device and waits for them, and must not deadlock."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
    from nnstreamer_tpu_torch.graph.node import _UNCHECKED

    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (IMAGE, IMAGE, 3)).astype(np.uint8),
              rng.integers(0, 256, (SSD_IMAGE, SSD_IMAGE, 3)).astype(np.uint8),
              rng.integers(0, 256, (IMAGE, IMAGE, 3)).astype(np.uint8),
              rng.integers(256, 30000, (IMAGE, IMAGE, 3)).astype(np.int16)]
    p = nns.parse_launch(
        f"datasrc name=s ! tensor_transform mode=arithmetic option={NORMALIZE} "
        "acceleration=pallas ! tensor_upload name=u ! queue ! tensor_filter framework=torch "
        "name=f ! tensor_sink name=out")
    p["s"].data = [torch.from_numpy(f) for f in frames]
    p["f"].model = TorchModel(apply=lambda params, x: x * 2, name="double", device="cuda")
    got = []
    p["out"].connect("new-data", got.append)
    u = p["u"]
    upload = u.process

    def held_upload(pad, frame):
        with torch.cuda.stream(u._stream):
            torch.cuda._sleep(UPLOAD_HOLD_CYCLES)
        return upload(pad, frame)

    u.process = held_upload
    hold = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    hold[0].record()
    torch.cuda._sleep(UPLOAD_HOLD_CYCLES)
    hold[1].record()
    hold[1].synchronize()
    hold_ms = hold[0].elapsed_time(hold[1])
    gate = u._lock
    gate.acquire()
    try:
        p.start()
    except BaseException:
        gate.release()
        raise
    try:
        for node in p.nodes.values():
            if node is not p["f"]:
                for pad in node.src_pads.values():
                    pad.sig = _UNCHECKED
        gate.release()
        check(p.wait(120), "the drift pipeline did not finish")
        be = p["f"].backend
        stats = dict(be.stats)
        waits = [(" ".join(f"{d}{shape}" for d, shape in key[0]), e.warmup_s * 1e3,
                  e.capture_s * 1e3) for key, e in be._graphs.items()]
        check(len(got) == len(frames), f"drift: {len(got)} of {len(frames)} frames")
        with torch.inference_mode():
            for i, (x, g) in enumerate(zip(frames, got)):
                xd = torch.from_numpy(x).cuda()
                out = be.invoke((xd,))[0]  # rebinds as the frame did
                want = be.eager(xd)[0]
                torch.cuda.synchronize()
                check(bitwise_equal(torch, g.tensor(0), want) and bitwise_equal(torch, out, want),
                      f"drift frame {i} {x.dtype}{x.shape}: the replay differs from eager")
    finally:
        p.stop()
    check(stats["captures"] == 3 and stats["hits"] == 1,
          f"drift: expected 3 captures and 1 LRU hit: {stats}")
    x16 = torch.from_numpy(frames[3]).cuda()
    want16 = K.fused_arith_plain(x16, bind(NORMALIZE, np.dtype(np.int16))) * 2
    cast = K.fused_arith_plain(x16.to(torch.uint8), ops) * 2
    check(bitwise_equal(torch, got[3].tensor(0), want16),
          "drift: the int16 frame's output is not the int16 chain's")
    check(not torch.equal(got[3].tensor(0), cast), "drift: the int16 frame was cast to uint8")
    res = dict(frames=len(frames), captures=stats["captures"], hits=stats["hits"],
               replays=stats["replays"], shapes=[f"{f.dtype}{f.shape}" for f in frames],
               hold_ms=hold_ms, capture_ms=[{"key": k, "warmup_ms": w, "capture_ms": c}
                                            for k, w, c in waits])
    print(f"drift: {res['shapes']} with no caps event: {stats['captures']} captures, "
          f"{stats['hits']} LRU hit, each output bitwise equal to eager, the int16 frame "
          "computed as int16", flush=True)
    print(f"drift: the upload's stream held {hold_ms:.3f} ms before each copy; each capture's "
          "warm-up and capture, in LRU order (the uint8 (224, 224, 3) one was taken before "
          "PLAYING): " + "; ".join(f"{k} {w:.3f} + {c:.3f} ms" for k, w, c in waits), flush=True)
    return res


def custom_so_phase(torch, np, root):
    """A C filter (``custom-so``) behind an upload: it gets tensors on the
    card, copies them to the host for the call, and its outputs are exact."""
    import nnstreamer_tpu_torch as nns

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    cc, so = os.path.join(work, "scaler_so.cc"), os.path.join(work, "libscaler_so.so")
    with open(cc, "w", encoding="utf-8") as f:
        f.write(SCALER_SO_SRC)
    header = os.path.join(root, "nnstreamer_tpu_torch", "native")
    build = subprocess.run(["g++", "-O2", "-shared", "-fPIC", f"-I{header}", cc, "-o", so],
                           capture_output=True, text=True, timeout=120)
    check(build.returncode == 0, f"g++ failed on the custom-so filter: {build.stderr}")
    rng = np.random.default_rng(12)
    sent = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(SO_FRAMES)]
    p = nns.parse_launch(
        "datasrc name=s ! tensor_upload name=u ! queue ! tensor_filter framework=custom-so "
        f"name=f model={so} custom={SO_SCALE} ! tensor_sink name=out")
    p["s"].data = [torch.from_numpy(f) for f in sent]
    be = p["f"].backend
    devices = []
    invoke = be.invoke

    def recording(tensors):
        devices.extend(t.device.type for t in tensors)
        return invoke(tensors)

    be.invoke = recording
    got = []
    p["out"].connect("new-data", lambda fr: got.append(fr.tensor(0)))
    p.run(timeout=120)
    check(devices == ["cuda"] * SO_FRAMES, f"custom-so got tensors on {devices}")
    check(len(got) == SO_FRAMES and all(g.device.type == "cpu" for g in got),
          "custom-so outputs are not host tensors")
    for i, (g, x) in enumerate(zip(got, sent)):
        check(np.array_equal(g.numpy(), x * np.float32(SO_SCALE)),
              f"custom-so frame {i}: not x * {SO_SCALE}")
    print(f"custom-so: {SO_FRAMES} frames uploaded to the card, copied to the host for the C "
          f"filter, outputs exactly x * {SO_SCALE}", flush=True)
    return dict(frames=SO_FRAMES, input_devices=sorted(set(devices)))


def upload_wait_check(seen, sent):
    """Each frame a sink callback read must hold its source's bytes."""
    check(len(seen) == len(sent), f"the sink read {len(seen)} of {len(sent)} frames")
    bad = [i for i, (got, want) in enumerate(zip(seen, sent))
           if not np.array_equal(got.reshape(-1), want)]
    check(not bad, f"frames {bad} were read before their upload's copy completed")


def upload_wait_phase(torch, np):
    """A sink fed straight by tensor_upload reads each frame after its copy,
    though the copy's stream is held back."""
    import nnstreamer_tpu_torch as nns

    rng = np.random.default_rng(5)
    rows, cols = (int(d) for d in UPLOAD_FRAME_DIMS.split(":"))
    sent = [rng.integers(0, 256, rows * cols, dtype=np.uint8) for _ in range(UPLOAD_FRAMES)]
    p = nns.parse_launch(
        f"datasrc name=s ! tensor_converter input-dim={UPLOAD_FRAME_DIMS} input-type=uint8 ! "
        "tensor_upload name=u ! queue ! tensor_sink name=out")
    p["s"].data = [torch.from_numpy(f) for f in sent]
    seen = []
    p["out"].connect("new-data", lambda fr: seen.append(fr.tensor(0).cpu().numpy()))
    u = p["u"]
    upload = u.process

    def held_upload(pad, frame):
        with torch.cuda.stream(u._stream):
            torch.cuda._sleep(UPLOAD_HOLD_CYCLES)
        return upload(pad, frame)

    u.process = held_upload
    t0 = time.perf_counter()
    p.run(timeout=120)
    upload_wait_check(seen, sent)
    res = dict(frames=len(sent), frame_bytes=rows * cols, hold_cycles=UPLOAD_HOLD_CYCLES,
               wall_s=time.perf_counter() - t0)
    print(f"upload wait: {len(sent)} frames of {rows * cols} bytes read by a new-data callback "
          f"equal their source, the upload's stream held {UPLOAD_HOLD_CYCLES} cycles before "
          f"each copy ({res['wall_s']:.3f} s)", flush=True)
    return res


# The full-int8 trunk (quant phase): the flagship runs QUANT_FRAMES frames,
# its int8-head variant and the int8 SSD QUANT_SIDE_FRAMES; QUANT_CPU_FRAMES
# of the flagship's frames are held against the port's CPU forward.
QUANT_SIDE_FRAMES = 16
QUANT_CPU_FRAMES = 8
# Card against CPU (same params and scales, bf16): cuDNN's depthwise convs
# and oneDNN's round differently now and then, and a value that crosses a
# rounding step of the next int8 quantize moves a whole int8 step: the
# logits may differ by this share of the frame's largest logit (0.00046
# measured on the H100), and the labels must agree where the top-1 leads
# by twice that.
QUANT_LOGIT_REL_TOL = 0.01
# cuBLASLt's int8 GEMM kernels (torch._int_mm on the H100), by name: its
# CUTLASS 2 kernels (cutlass_80_tensorop_i16832gemm_s8_...) and its Hopper
# ones (sm90_xmma_gemm_i8i32_...).
INT8_GEMM_RE = r"gemm_s8|gemm_i8|i8i32"
# Device time classes of the int8 path, by the step that launched a kernel:
# the layer functions each class's kernels come from (models/layers.py).
SPLIT_STEPS = {"int_mm": "int8 GEMM", "_int8_quantize": "quantize and rescale",
               "_im2col": "quantize and rescale", "_int8_rescale": "quantize and rescale"}
SPLIT_CLASSES = ("int8 GEMM", "quantize and rescale", "depthwise conv", "other")


def int8_gemms(names) -> int:
    """The int8 GEMM kernel records in one launch's ``{name: count}``."""
    import re

    return sum(n for name, n in names.items() if re.search(INT8_GEMM_RE, name))


def split_by_step(events):
    """Device ms of each SPLIT_CLASSES class from a profiler's events: a
    kernel belongs to the class of the nearest enclosing range named after
    one (its launching runtime call shares its id), else to "other".  The
    ranges' own spans on the device timeline (CUPTI's user annotations,
    named as the range) are no kernels."""
    from torch.autograd import DeviceType

    cpu = {e.id: e for e in events if e.device_type == DeviceType.CPU}
    split = {c: 0.0 for c in SPLIT_CLASSES}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in split:
            continue
        cls, parent = "other", cpu.get(e.id)
        while parent is not None:
            if parent.name in split:
                cls = parent.name
                break
            parent = parent.cpu_parent
        split[cls] += e.device_time_total / 1e3
    return split


def device_split(torch, fn, frames):
    """Device ms per frame of each class, from one traced eager run of
    ``fn`` (``frames`` forwards): the replay's kernels are these, launched
    from a graph, where no host range can mark them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from nnstreamer_tpu_torch.models import layers

    def marked(label, f):
        def call(*a, **k):
            with record_function(label):
                return f(*a, **k)
        return call

    saved = {name: getattr(layers, name) for name in (*SPLIT_STEPS, "conv2d")}
    for name, label in SPLIT_STEPS.items():
        setattr(layers, name, marked(label, saved[name]))
    conv = saved["conv2d"]

    def conv2d(params, x, stride=1, groups=1, dtype=None, int8=False):
        if groups > 1:
            with record_function("depthwise conv"):
                return conv(params, x, stride, groups, dtype, int8)
        return conv(params, x, stride, groups, dtype, int8)

    layers.conv2d = conv2d
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for name, f in saved.items():
            setattr(layers, name, f)
    return {c: ms / frames for c, ms in split_by_step(prof.events()).items()}


def quant_checks(tr, gemms, kernels):
    """The quant paths' per-launch check on a traced run: 5 host-issued
    device operations a frame (the graph launch and 4 copies), as obs_checks
    counts them (CUPTI may lose the record of a runtime call, never adds
    one); each graph launch replays one captured graph that holds ``gemms``
    int8 GEMM records, one record of each path kernel in ``kernels`` and
    none of the other kernels (launch_check has held the path kernels; this
    adds the GEMMs).  The fullest launch must hold all of them, and no
    launch more.  A launch with fewer device records than the fullest lost
    them in the tracer (CUPTI drops one now and then, most often the first
    kernel of the trace's first launch): it may lack as many of these
    records as it lost, no more.  Returns the device records of a launch."""
    frames = len(tr["per_launch"])
    check(len(tr["names_per_launch"]) == frames > 0, "the trace holds no graph launch")
    ops = host_ops(tr["calls"])
    check(4.5 * frames <= ops <= 5 * frames,
          f"{ops} host-issued device operations over {frames} frames, expected 5 a frame")
    full = max(total for _, total in tr["per_launch"])
    for i, (names, (rec, total)) in enumerate(zip(tr["names_per_launch"], tr["per_launch"])):
        n = int8_gemms(names)
        check(n <= gemms, f"graph launch {i} holds {n} int8 GEMM records, expected {gemms}")
        for k in KERNEL_SYMBOLS:
            want = 1 if k in kernels else 0
            check(rec.get(k, 0) <= want, f"graph launch {i}: {rec.get(k, 0)} records of {k}, "
                                         f"expected {want}")
        missing = [k for k in kernels if not rec.get(k)]
        check(gemms - n + len(missing) <= full - total,
              f"graph launch {i} holds {n} int8 GEMM records of {gemms} and no record of "
              f"{missing}, yet {total} of the fullest launch's {full} device records: the "
              f"trunk did not run int8, or a path kernel left the graph (kernels: "
              f"{sorted(names)[:8]}...)")
    return full


def count_int8_gemms(torch, model, x):
    """The int8 products one eager forward of ``model`` calls."""
    from nnstreamer_tpu_torch.models import layers

    calls = []
    real = layers.int_mm
    layers.int_mm = lambda a, b: calls.append(a.shape) or real(a, b)
    try:
        with torch.inference_mode():
            model(x)
    finally:
        layers.int_mm = real
    return len(calls)


def quant_phase(torch, np, K, ops, root, card, float_busy_ms):
    """The full-int8 trunk (ROADMAP item 7) at full width from launch
    strings: config 1q, MobileNet-v2 1.0 with every ungrouped conv int8 and
    static scales calibrated when the filter opens (``model=<file>.npz
    custom=builder=mobilenet_v2:build_quantized,int8_convs=1,
    static_scales=1``); the same with the int8 head; and the int8 SSD
    (dynamic per-sample scales) through slice 2's detection string."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.decoders import bounding_boxes as bb
    from nnstreamer_tpu_torch.models import mobilenet_v2, ssd_mobilenet
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tree = mobilenet_v2.init_tree(0, CLASSES, 1.0)
    ckpt = os.path.join(work, "mobilenet_v2.npz")
    save_state(tree, ckpt)
    labels_path = os.path.join(work, "labels_1001.txt")
    with open(labels_path, "w", encoding="utf-8") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)))

    def desc(n, head=False):
        return (f"videotestsrc name=src num-buffers={n} width={IMAGE} height={IMAGE} "
                "pattern=random seed=7 ! tensor_converter ! "
                f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
                "tensor_upload name=u ! queue max-size-buffers=16 ! "
                f"tensor_filter framework=torch name=f model={ckpt} "
                "custom=builder=mobilenet_v2:build_quantized,int8_convs=1,static_scales=1"
                f"{',int8_head=1' if head else ''} ! "
                f"tensor_decoder mode=image_labeling option1={labels_path} ! tensor_sink name=out")

    # The builder called directly on the same tree: its wall time is the
    # calibration's (four frames, on the CPU) with the quantize and build.
    t0 = time.perf_counter()
    direct = mobilenet_v2.build_quantized(params=tree, int8_convs=True, static_scales=True,
                                          device="cuda")
    calib_s = time.perf_counter() - t0
    scales = [d["act_scale"] for d in _conv_dicts(direct.params) if "act_scale" in d]
    check(len(scales) == 35 and all(type(v) is float and v > 0 for v in scales),
          f"{len(scales)} calibrated scales, expected 35 Python floats")
    x0 = K.fused_arith(torch.from_numpy(np.zeros((IMAGE, IMAGE, 3), np.uint8)).cuda(), ops)
    gemms = count_int8_gemms(torch, direct, x0)
    check(gemms == 35, f"the full-int8 MobileNet-v2 calls {gemms} int8 GEMMs, expected 35 "
                       "(stem, 16 expand, 17 project, head)")
    print(f"config 1q: build_quantized(int8_convs, static_scales) with calibration in "
          f"{calib_s:.3f} s wall [{card}]; 35 scales, 35 int8 GEMMs a frame", flush=True)

    state = {}

    def during(p):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     transform_folded=not any(type(n).__name__ == "TensorTransform"
                                              for n in p.nodes.values()),
                     model=be.model.name,
                     scales=[d["act_scale"] for d in _conv_dicts(be.model.params)
                             if "act_scale" in d])
        src = p["src"]
        xs = [torch.from_numpy(src._make_frame(i)) for i in range(8)]
        captured_against_eager(torch, be, xs, exact=True)
        return p

    def run_path(n, head):
        run_pipeline(nns, desc(WARMUP_FRAMES, head), None, WARMUP_FRAMES)
        K.reset_launches()
        got = []
        p, arrivals, _ = run_pipeline(nns, desc(n, head), None, n, during=during, got=got)
        stats, launches = state["stats"], state["launches"]
        print(f"config 1q{' + int8 head' if head else ''} over {n} frames: {state['model']}, "
              f"backend {stats}, wrapper launches {launches}", flush=True)
        check(state["transform_folded"], "the normalize did not fold into the filter")
        check(stats["captures"] == 1 and stats["replays"] == n,
              f"expected one capture and {n} replays: {stats}")
        check(state["scales"] == scales, "the filter's model calibrated to other scales than "
                                         "the builder called directly")
        want = {"fused_arith": stats["warmup_calls"] + 1,
                "int8_matmul": stats["warmup_calls"] + 1 if head else 0, "pallas_nms_keep": 0}
        check(launches == want, f"wrapper launches {launches}, expected {want}")
        print("captured against eager: logits bitwise equal on 8 frames", flush=True)
        return p, arrivals, got, stats, launches

    p, arrivals, got, stats, launches = run_path(FRAMES, False)
    # The pipeline's labels against the direct build on the card, and the
    # card's logits against the port's CPU forward of the same params and
    # scales on the same normalized frames.
    cpu = mobilenet_v2.build_quantized(params=tree, int8_convs=True, static_scales=True,
                                       device="cpu")
    check([d["act_scale"] for d in _conv_dicts(cpu.params) if "act_scale" in d] == scales,
          "the CPU build calibrated to other scales")
    src = p["src"]
    want_idx, rel_err, compared = [], 0.0, 0
    with torch.inference_mode():
        for i in range(FRAMES):
            x = K.fused_arith(torch.from_numpy(src._make_frame(i)).cuda(), ops)
            logits = direct(x)
            check(bool(torch.isfinite(logits).all()) and logits.shape == (CLASSES,),
                  f"frame {i}: logits not finite / wrong shape")
            want_idx.append(int(torch.argmax(logits)))
            if i < QUANT_CPU_FRAMES:
                ref = cpu(x.cpu()).double()
                scale = float(ref.abs().max())
                rel_err = max(rel_err, float((logits.double().cpu() - ref).abs().max()) / scale)
                top2 = torch.topk(ref, 2).values
                if float(top2[0] - top2[1]) > 2 * QUANT_LOGIT_REL_TOL * scale:
                    compared += 1
                    check(int(torch.argmax(ref)) == want_idx[-1],
                          f"frame {i}: label {want_idx[-1]} on the card, "
                          f"{int(torch.argmax(ref))} on the CPU")
    got_idx = [f.meta["label_index"] for f in got]
    check(got_idx == want_idx, f"labels differ from the direct build: {got_idx} vs {want_idx}")
    check(rel_err <= QUANT_LOGIT_REL_TOL,
          f"card logits differ from the CPU forward by {rel_err} of the largest logit")
    res = dict(frames=FRAMES, replays=stats["replays"], **rates(arrivals, np),
               distinct_labels=len(set(got_idx)), calibration_build_s=calib_s,
               cpu_logit_rel_err=rel_err, cpu_labels_compared=compared,
               capture_s=stats["capture_s"], warmup_s=stats["warmup_s"])
    print(f"config 1q: labels equal to the direct build ({len(set(got_idx))} distinct); card "
          f"logits within {rel_err:.4g} of the largest of the CPU forward's (tolerance "
          f"{QUANT_LOGIT_REL_TOL}), labels equal on the {compared} of {QUANT_CPU_FRAMES} frames "
          f"whose top-1 leads by more than twice that", flush=True)
    tr = profile_path(lambda n: traced_run(nns, desc(n), None, n), res, ("fused_arith",))
    res["device_records_per_launch"] = quant_checks(tr, 35, ("fused_arith",))
    xs = [K.fused_arith(torch.from_numpy(src._make_frame(i)).cuda(), ops) for i in range(4)]

    def forwards(model):
        def run():
            with torch.inference_mode():
                for x in xs:
                    model(x)
        return run

    res["device_ms_per_frame_by_class"] = device_split(torch, forwards(direct), len(xs))
    res["slice1_float_busy_ms_per_frame"] = float_busy_ms
    top = sorted(tr["us_by_name"].items(), key=lambda kv: -kv[1])[:12]
    report_path("config 1q", res, card)
    print(f"  config 1q device records a launch: {res['device_records_per_launch']}, of them "
          f"35 int8 GEMMs and 1 fused_arith [{card}]", flush=True)
    for cls, ms in res["device_ms_per_frame_by_class"].items():
        print(f"  config 1q device ms/frame, {cls} (eager, {len(xs)} frames): {ms} [{card}]",
              flush=True)
    print(f"  config 1q busy {res['device_busy_ms_per_frame']} ms/frame against slice 1's float "
          f"trunk {float_busy_ms} ms/frame, same run [{card}]", flush=True)
    for name, us in top:
        print(f"  config 1q kernel {us / PROFILED:.2f} us/frame: {name[:160]}", flush=True)
    quant = (launches, res)

    # The same string with the int8 head: int8_matmul once a frame.
    _, h_arrivals, _, h_stats, h_launches = run_path(QUANT_SIDE_FRAMES, True)
    h_res = dict(frames=QUANT_SIDE_FRAMES, replays=h_stats["replays"],
                 **rates(h_arrivals, np))
    tr = profile_path(lambda n: traced_run(nns, desc(n, True), None, n), h_res,
                      ("fused_arith", "int8_matmul"))
    h_res["device_records_per_launch"] = quant_checks(tr, 35, ("fused_arith", "int8_matmul"))
    head = mobilenet_v2.build_quantized(params=tree, int8_convs=True, static_scales=True,
                                        int8_head=True, device="cuda")
    h_res["device_ms_per_frame_by_class"] = device_split(torch, forwards(head), len(xs))
    report_path("config 1q + int8 head", h_res, card)

    # The int8 SSD through slice 2's detection string, segments on.
    labels = os.path.join(work, "labels.txt")
    with open(labels, "w", encoding="utf-8") as f:
        f.write("\n".join(["background"] + [f"object_{i}" for i in range(1, SSD_LABELS)]))
    priors_path = ssd_mobilenet.write_priors_file(os.path.join(work, "priors.txt"), SSD_IMAGE)
    model = ssd_mobilenet.build_quantized(num_labels=SSD_LABELS, image_size=SSD_IMAGE, seed=0,
                                          device="cuda")
    xs0 = K.fused_arith(torch.from_numpy(np.zeros((SSD_IMAGE, SSD_IMAGE, 3), np.uint8)).cuda(),
                        ops)
    ssd_gemms = count_int8_gemms(torch, model, xs0)
    check(ssd_gemms == 50, f"the int8 SSD calls {ssd_gemms} int8 GEMMs, expected 50 (stem, 33 "
                           "expand and project, 4 extras, 12 heads)")
    wh = f"{SSD_IMAGE}:{SSD_IMAGE}"

    def sdesc(n):
        return (f"videotestsrc name=src num-buffers={n} width={SSD_IMAGE} height={SSD_IMAGE} "
                "pattern=random seed=11 ! tensor_converter name=conv ! "
                f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
                "tensor_upload name=u ! queue max-size-buffers=16 ! "
                "tensor_filter framework=torch name=f ! "
                f"tensor_decoder name=dec mode=bounding_boxes option1=tflite-ssd "
                f"option2={labels} option3={priors_path} option4={wh} option5={wh} ! "
                "tensor_sink name=out collect=true")

    sstate = {}

    def sduring(p):
        be = p["f"].backend
        sstate.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                      lowered=p["dec"].plugin._lowered is not None)
        xs = [torch.from_numpy(p["src"]._make_frame(i)) for i in range(8)]
        captured_against_eager(torch, be, xs, exact=True)
        return p

    run_pipeline(nns, sdesc(WARMUP_FRAMES), model, WARMUP_FRAMES, seg=True)
    K.reset_launches()
    sp, s_arrivals, _ = run_pipeline(nns, sdesc(QUANT_SIDE_FRAMES), model, QUANT_SIDE_FRAMES,
                                     seg=True, during=sduring)
    s_stats, s_launches = sstate["stats"], sstate["launches"]
    print(f"int8 SSD over {QUANT_SIDE_FRAMES} frames: backend {s_stats}, wrapper launches "
          f"{s_launches}", flush=True)
    check(sstate["lowered"] and s_stats["captures"] == 1
          and s_stats["replays"] == QUANT_SIDE_FRAMES,
          f"int8 SSD: lowered {sstate['lowered']}, backend {s_stats}")
    want = {"fused_arith": s_stats["warmup_calls"] + 1, "int8_matmul": 0,
            "pallas_nms_keep": s_stats["warmup_calls"] + 1}
    check(s_launches == want, f"int8 SSD wrapper launches {s_launches}, expected {want}")
    priors = ssd_mobilenet.generate_priors(SSD_IMAGE)
    n_objects = 0
    with torch.inference_mode():
        for i, frame in enumerate(sp["out"].frames):
            x = K.fused_arith(torch.from_numpy(sp["src"]._make_frame(i)).cuda(), ops)
            boxes, scores = model(x)
            check(bool(torch.isfinite(boxes).all()) and bool(torch.isfinite(scores).all()),
                  f"int8 SSD frame {i}: raw outputs not finite")
            host = bb.nms(bb.decode_tflite_ssd(boxes.cpu().numpy(), scores.cpu().numpy(),
                                               priors, SSD_IMAGE, SSD_IMAGE))
            check([(o.class_id, o.x, o.y, o.width, o.height) for o in host] == _objects(frame),
                  f"int8 SSD frame {i}: device detections differ from the host decode of the "
                  "eager forward")
            n_objects += len(host)
    check(n_objects > 0, "int8 SSD: no detections")
    s_res = dict(frames=QUANT_SIDE_FRAMES, replays=s_stats["replays"], objects=n_objects,
                 **rates(s_arrivals, np))
    print(f"int8 SSD: {n_objects} detections equal to the host decode of the eager forward; "
          f"replays bitwise equal to eager on 8 frames", flush=True)
    tr = profile_path(lambda n: traced_run(nns, sdesc(n), model, n, seg=True), s_res,
                      ("fused_arith", "pallas_nms_keep"))
    s_res["device_records_per_launch"] = quant_checks(tr, 50, ("fused_arith", "pallas_nms_keep"))
    xs = [K.fused_arith(torch.from_numpy(sp["src"]._make_frame(i)).cuda(), ops)
          for i in range(4)]
    s_res["device_ms_per_frame_by_class"] = device_split(torch, forwards(model), len(xs))
    report_path("int8 SSD", s_res, card)
    for cls, ms in s_res["device_ms_per_frame_by_class"].items():
        print(f"  int8 SSD device ms/frame, {cls} (eager, {len(xs)} frames): {ms} [{card}]",
              flush=True)
    return quant, (h_launches, h_res), (s_launches, s_res)


# -- config 3 (pose) and config 4 / 4b (the LSTM recurrence) ---------------

DEVICE = "cuda"         # where the pose and recurrence phases build their models
POSE_SIDE_FRAMES = 16   # the heatmap form and the int8 form
POSE_CPU_FRAMES = 8     # frames held against the port's CPU forward
POSE_CONV_FRAMES = 2    # frames whose every conv is held to its accumulation bounds
# A keypoint's cell must be the CPU forward's wherever its channel's top-1
# leads the second by more than this (bf16 heatmaps: 1/256 a step near 1).
POSE_MARGIN = 0.03
POSE_JOINTS = ("top", "neck", "r_shoulder", "r_elbow", "r_wrist", "l_shoulder", "l_elbow",
               "l_wrist", "r_hip", "r_knee", "r_ankle", "l_hip", "l_knee", "l_ankle")
LSTM_STEPS = 200        # config 4's steps (bench.py's leg_config4)
LSTM_HIDDEN = 64        # bench.py's width
LSTM_SLOTS = (90, 91)   # bench.py's slots for h and c
# The card's h against the port's CPU forward, over 200 steps (PR 11's
# runs: 2.09e-07); TF32 products, which must stay off, exceed it.
LSTM_CPU_ATOL = 1e-5
SEQ_WINDOWS = 32        # config 4b
SEQ_LEN = 128
SEQ_WIDTH = 512
SEQ_CPU_WINDOWS = 2
SEQ_CPU_ATOL = 1e-5     # config 4b's windows (PR 11's runs: 8.64e-07)


def with_tf32(torch, fn):
    """``fn()`` with TF32 on for float32 matmuls, then off again (``main``
    turns it off): shows that a tolerance rejects TF32 products."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def keypoints_of(np, hm):
    """The decoder's host decode of (H, W, 14) heatmaps: per channel the
    argmax cell (the first of equal maxima) as (x, y, score)."""
    hm = np.asarray(hm, np.float32)
    flat = hm.reshape(-1, hm.shape[-1])
    idx = flat.argmax(axis=0)
    ys, xs = np.unravel_index(idx, hm.shape[:2])
    return [(int(x), int(y), float(flat[i, k]))
            for k, (x, y, i) in enumerate(zip(xs, ys, idx))]


def keypoint_check(np, got, eager_hm, cpu_hm, margin):
    """A frame's keypoints from the pipeline: equal to the argmax over the
    card's eager heatmaps (cells and scores), and each cell equal to the CPU
    forward's wherever that channel's top-1 leads by more than ``margin``.
    Returns the channels held against the CPU."""
    want = keypoints_of(np, eager_hm)
    check(list(got) == want, f"keypoints {list(got)} differ from the argmax of the eager "
                             f"heatmaps {want}")
    if cpu_hm is None:
        return 0
    ref = keypoints_of(np, cpu_hm)
    top2 = np.sort(np.asarray(cpu_hm, np.float32).reshape(-1, len(ref)), axis=0)[-2:]
    compared = 0
    for k, ((gx, gy, _), (wx, wy, _)) in enumerate(zip(got, ref)):
        if top2[1, k] - top2[0, k] > margin:
            compared += 1
            check((gx, gy) == (wx, wy),
                  f"keypoint {k}: ({gx}, {gy}) on the card, ({wx}, {wy}) on the CPU")
    return compared


def accumulation_bounds(torch, x, w, stride, padding, groups):
    """The least and greatest bfloat16 value of each lane of a bfloat16 conv
    whose products (exact in float32: 8 x 8 significand bits) are summed in
    float32, in any order, rounding to nearest or toward zero, and rounded to
    bfloat16 once: the exact sum ``s`` (float64) widened by
    ``2 * K * 2**-24 * sum(|products|)``, ``K`` the products of a lane,
    then rounded (rounding is monotone, so the bounds hold)."""
    F = torch.nn.functional
    xd, wd = x.detach().cpu().double(), w.detach().cpu().double()
    s = F.conv2d(xd, wd, stride=stride, padding=padding, groups=groups)
    e = F.conv2d(xd.abs(), wd.abs(), stride=stride, padding=padding, groups=groups)
    e = e * (2 * wd[0].numel() * 2.0 ** -24)
    return (s - e).to(torch.bfloat16), (s + e).to(torch.bfloat16)


def conv_calls(torch, fn, replace=None):
    """Run ``fn()`` with every conv of the port's ``models/layers.py``
    recorded: returns ``fn``'s result and a list of calls, each a dict of
    ``x``, ``w``, ``stride``, ``padding``, ``groups`` and its output ``out``.
    ``replace(i, call)``, when given, returns the tensor that the ``i``-th
    conv hands on in place of its own output."""
    from nnstreamer_tpu_torch.models import layers

    F, calls = torch.nn.functional, []

    class Recorder:
        def __getattr__(self, name):
            return getattr(F, name)

        def conv2d(self, x, w, stride=1, padding=0, groups=1):
            call = dict(x=x, w=w, stride=stride, padding=padding, groups=groups,
                        out=F.conv2d(x, w, stride=stride, padding=padding, groups=groups))
            calls.append(call)
            return call["out"] if replace is None else replace(len(calls) - 1, call)

    layers.F = Recorder()
    try:
        return fn(), calls
    finally:
        layers.F = F


def conv_lanes_outside(torch, call, out=None):
    """The lanes of a recorded bfloat16 conv (or of ``out``, another
    result for the same operands) outside :func:`accumulation_bounds`."""
    lo, hi = accumulation_bounds(torch, call["x"], call["w"], call["stride"], call["padding"],
                                 call["groups"])
    out = (call["out"] if out is None else out).detach().cpu()
    return int(((out < lo) | (out > hi)).sum())


def pose_conv_check(torch, apply, card_params, cpu_params, x):
    """The pose net's every bfloat16 conv on the card against the float32
    accumulation bounds of its own operands, and every other step (batch
    norm, relu6, the residual adds, the sigmoid) against the port's CPU
    forward fed the card's conv outputs: each conv's input and the heatmaps
    bit for bit.  Returns (convs, lanes, heatmap values compared)."""
    hm, calls = conv_calls(torch, lambda: apply(card_params, x))
    lanes = 0
    for i, call in enumerate(calls):
        check(call["x"].device == x.device and call["out"].dtype == torch.bfloat16,
              f"pose conv {i} did not run in bfloat16 on {x.device}")
        bad = conv_lanes_outside(torch, call)
        check(bad == 0, f"pose conv {i}: {bad} lanes outside the float32 accumulation bounds")
        lanes += call["out"].numel()

    def card_out(i, call):
        check(bitwise_equal(torch, call["x"], calls[i]["x"].cpu()),
              f"pose conv {i}: its input differs from the card's")
        return calls[i]["out"].cpu()

    cpu_hm, cpu_calls = conv_calls(torch, lambda: apply(cpu_params, x.cpu()), card_out)
    check(len(cpu_calls) == len(calls), "the CPU forward made another number of convs")
    check(bitwise_equal(torch, hm.cpu(), cpu_hm),
          "the card's heatmaps differ from the CPU forward fed the card's conv outputs")
    return len(calls), lanes, hm.numel()


def memcpy_counts(count_by_name):
    """Device copies in a trace by direction, from CUPTI's record names."""
    out = {"DtoH": 0, "HtoD": 0, "DtoD": 0}
    for name, n in count_by_name.items():
        for kind in out:
            if name.startswith("Memcpy") and kind in name:
                out[kind] += n
    return out


def recurrence_checks(stats, steps, copies, dtoh):
    """Config 4's cycle: one capture (the repo sources' zero bootstrap has
    the captured spec and device, so nothing recaptures), a replay a step,
    and no device→host copy: the ``copies`` tracer counts none and CUPTI
    records no DtoH copy."""
    check(stats["captures"] == 1 and stats["replays"] == steps,
          f"expected one capture and {steps} replays: {stats}")
    check(copies == 0, f"the copies tracer counted {copies} host copies on the cycle")
    check(dtoh == 0, f"{dtoh} device-to-host copies on the cycle")


def pose_phase(torch, np, K, ops, root, card):
    """Config 3 at full width from launch strings: PoseNet on MobileNet-v2
    1.0 at 224x224x3 uint8, bf16, a 14x14 grid, the model named in the
    string with its keypoints decoded on the card (``fused_decode=1``);
    then the heatmap form (the decoder's host argmax) and the int8 model."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.models import posenet
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tree = posenet.init_tree(0)
    ckpt = os.path.join(work, "posenet.npz")
    save_state(tree, ckpt)
    joints = os.path.join(work, "joints.txt")
    with open(joints, "w", encoding="utf-8") as f:
        f.write("\n".join(POSE_JOINTS))
    grid = posenet.grid_size(IMAGE)

    def desc(n, builder="build", fused=True):
        return (f"videotestsrc name=src num-buffers={n} width={IMAGE} height={IMAGE} "
                "pattern=random seed=7 ! tensor_converter ! "
                f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
                "tensor_upload name=u ! queue max-size-buffers=16 ! "
                f"tensor_filter framework=torch name=f model={ckpt} "
                f"custom=builder=posenet:{builder}{',fused_decode=1' if fused else ''} ! "
                f"tensor_decoder mode=pose_estimation option1={IMAGE}:{IMAGE} "
                f"option2={grid}:{grid} option3={joints} ! tensor_sink name=out")

    heat = posenet.build(params=tree, device=DEVICE)
    heat_q = posenet.build_quantized(params=tree, device=DEVICE)
    cpu = posenet.build(params=tree, device="cpu")
    x0 = K.fused_arith(torch.from_numpy(np.zeros((IMAGE, IMAGE, 3), np.uint8)).to(DEVICE), ops)
    gemms = count_int8_gemms(torch, heat_q, x0)
    check(gemms == 27, f"the int8 pose net calls {gemms} int8 GEMMs, expected 27 (stem, 12 "
                       "expand, 13 project, head)")
    state = {}

    def during(p):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     transform_folded=not any(type(n).__name__ == "TensorTransform"
                                              for n in p.nodes.values()))
        xs = [torch.from_numpy(p["src"]._make_frame(i)) for i in range(8)]
        captured_against_eager(torch, be, xs, exact=True)
        return p

    def run_form(n, builder, fused, model, cpu_model):
        run_pipeline(nns, desc(WARMUP_FRAMES, builder, fused), None, WARMUP_FRAMES)
        K.reset_launches()
        got = []
        p, arrivals, _ = run_pipeline(nns, desc(n, builder, fused), None, n, during=during,
                                      got=got)
        stats, launches = state["stats"], state["launches"]
        name = f"pose {builder}{' fused' if fused else ' heatmaps'}"
        print(f"{name} over {n} frames: backend {stats}, wrapper launches {launches}",
              flush=True)
        check(state["transform_folded"], "the normalize did not fold into the filter")
        check(stats["captures"] == 1 and stats["replays"] == n,
              f"expected one capture and {n} replays: {stats}")
        want = {"fused_arith": stats["warmup_calls"] + 1, "int8_matmul": 0,
                "pallas_nms_keep": 0}
        check(launches == want, f"wrapper launches {launches}, expected {want}")
        compared = 0
        with torch.inference_mode():
            for i, frame in enumerate(got):
                x = K.fused_arith(torch.from_numpy(p["src"]._make_frame(i)).to(DEVICE), ops)
                hm = model(x)
                check(bool(torch.isfinite(hm).all()) and tuple(hm.shape) == (grid, grid, 14),
                      f"{name} frame {i}: heatmaps not finite / wrong shape")
                check(frame.tensor(0).shape == (IMAGE, IMAGE, 4), f"{name}: overlay shape")
                ref = cpu_model(x.cpu()).numpy() if i < POSE_CPU_FRAMES and cpu_model else None
                compared += keypoint_check(np, frame.meta["pose"], hm.cpu().numpy(), ref,
                                           POSE_MARGIN)
        res = dict(frames=n, replays=stats["replays"], **rates(arrivals, np),
                   cpu_keypoints_compared=compared, capture_s=stats["capture_s"],
                   warmup_s=stats["warmup_s"])
        print(f"{name}: replays bitwise equal to eager on 8 frames; keypoints equal to the "
              f"argmax of the eager heatmaps on {n} frames; {compared} keypoints of "
              f"{POSE_CPU_FRAMES if cpu_model else 0} frames held against the CPU forward "
              f"(top-1 margin above {POSE_MARGIN})", flush=True)
        return p, launches, res

    p, launches, res = run_form(FRAMES, "build", True, heat, cpu)
    convs = lanes = values = 0
    with torch.inference_mode():
        for i in range(POSE_CONV_FRAMES):
            x = K.fused_arith(torch.from_numpy(p["src"]._make_frame(i)).to(DEVICE), ops)
            c, n, v = pose_conv_check(torch, posenet.apply, heat.params, cpu.params, x)
            convs, lanes, values = convs + c, lanes + n, values + v
    res.update(conv_checked=convs, conv_lanes_checked=lanes, heatmap_values_bitwise=values)
    print(f"pose: {convs} bfloat16 convs of {POSE_CONV_FRAMES} frames on the card ({lanes} "
          "lanes) within the float32 accumulation bounds of their operands; the card's "
          f"heatmaps ({values} values) equal the CPU forward fed the card's conv outputs, bit "
          "for bit", flush=True)
    tr = profile_path(lambda n: traced_run(nns, desc(n), None, n), res, ("fused_arith",))
    res["device_records_per_launch"] = quant_checks(tr, 0, ("fused_arith",))
    report_path("pose (config 3)", res, card)
    print(f"  pose device records a launch: {res['device_records_per_launch']}, of them 1 "
          f"fused_arith [{card}]", flush=True)
    _, _, h_res = run_form(POSE_SIDE_FRAMES, "build", False, heat, None)
    tr = profile_path(lambda n: traced_run(nns, desc(n, fused=False), None, n), h_res,
                      ("fused_arith",))
    h_res["device_records_per_launch"] = quant_checks(tr, 0, ("fused_arith",))
    report_path("pose, heatmaps decoded on the host", h_res, card)
    _, _, q_res = run_form(POSE_SIDE_FRAMES, "build_quantized", True, heat_q, None)
    tr = profile_path(lambda n: traced_run(nns, desc(n, "build_quantized"), None, n), q_res,
                      ("fused_arith",))
    q_res["device_records_per_launch"] = quant_checks(tr, gemms, ("fused_arith",))
    report_path("pose, int8", q_res, card)
    print(f"  pose int8 device records a launch: {q_res['device_records_per_launch']}, of "
          f"them {gemms} int8 GEMMs and 1 fused_arith [{card}]", flush=True)
    return (launches, res), h_res, q_res


def lstm_pipeline(nns, torch, np, xs, model, slots, tracers=()):
    """Config 4's graph (``examples/pipelines/recurrence_lstm.py``) through
    the Pipeline API: repo sources for h and c (their bootstrap on the card)
    and a data source for x → ``tensor_mux sync-mode=nosync`` → the LSTM
    cell → ``tensor_demux`` → h through a tee to its repo sink and the sink,
    c to its repo sink."""
    from nnstreamer_tpu_torch.buffer import SECOND, Frame
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.repo import TensorRepoSink, TensorRepoSrc

    caps = nns.TensorsSpec(tensors=(nns.TensorSpec(dtype=np.float32, shape=(LSTM_HIDDEN,)),))
    src_kw = {"device": DEVICE}
    dur = SECOND // 30
    p = nns.Pipeline(name="lstm")
    p.add(TensorRepoSrc(name="h_src", slot_index=slots[0], caps=caps, **src_kw),
          TensorRepoSrc(name="c_src", slot_index=slots[1], caps=caps, **src_kw),
          nns.make("datasrc", "x_src", data=[Frame.of(torch.from_numpy(x), pts=i * dur,
                                                      duration=dur) for i, x in xs]),
          nns.make("tensor_mux", "mux", sync_mode="nosync"),
          TensorFilter(name="f", framework="torch", model=model),
          nns.make("tensor_demux", "demux"), nns.make("tee", "tee"),
          TensorRepoSink(name="h_sink", slot_index=slots[0]),
          TensorRepoSink(name="c_sink", slot_index=slots[1]),
          nns.make("tensor_sink", "out"))
    for i, src in enumerate(("h_src", "c_src", "x_src")):
        p.link(src, f"mux.sink_{i}")
    p.link_chain("mux", "f", "demux")
    p.link("demux.src_0", "tee")
    p.link("tee", "h_sink")
    p.link("tee", "out")
    p.link("demux.src_1", "c_sink")
    for name in tracers:
        p.attach_tracer(name)
    return p


def run_lstm(nns, torch, np, xs, model, during=None, restore=None, tracers=(),
             traced=False):
    """Run config 4 over ``xs`` ((step, x) pairs); the h of every step, the
    sink's arrival times and last the card's end of the last step, the
    pipeline, and ``during(p)``'s result (it runs after EOS while the filter
    is open), or with ``traced`` the trace of the steps: the x source waits
    until start() (negotiation, capture) returned and the profiler runs.
    ``restore(p)`` runs before start."""
    import threading

    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO

    p = lstm_pipeline(nns, torch, np, xs, model, LSTM_SLOTS, tracers)
    hs, arrivals = [], []
    p["out"].connect("new-data", lambda f: (arrivals.append(time.perf_counter()),
                                            hs.append(f.tensor(0))))
    if restore is not None:
        restore(p)
    gate = threading.Event()
    if traced:
        frames = p["x_src"].frames

        def gated():
            gate.wait()
            yield from frames()

        p["x_src"].frames = gated
    p.start()
    try:
        if traced:
            result = trace(lambda: (time.sleep(0.25), gate.set(),
                                    check(p.wait(600), "traced config 4 did not finish")))
        else:
            check(p.wait(600), "config 4 did not finish within 600 s")
            torch.cuda.synchronize()
            arrivals.append(time.perf_counter())  # the card's end of the last step
            result = during(p) if during is not None else None
    finally:
        gate.set()
        p.stop()
    check(len(hs) == len(xs), f"config 4 delivered {len(hs)} of {len(xs)} steps")
    for s in LSTM_SLOTS:
        check(GLOBAL_REPO.slot(s).eos, f"slot {s} did not reach EOS")
    return hs, arrivals, p, result


def recurrence_phase(torch, np, K, root, card):
    """Config 4: the LSTM cell (``lstm:build_cell``, hidden 64) in the
    repo-slot cycle for 200 steps, then stopped after 100, checkpointed,
    restored into a new pipeline and run 100 more; config 4b: the sequence
    model (input and hidden 512, 128 steps a window) over 32 windows."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
    from nnstreamer_tpu_torch.models import lstm
    from nnstreamer_tpu_torch.utils.checkpoint import checkpoint_pipeline, restore_pipeline

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tree = lstm.init_tree(0, LSTM_HIDDEN, LSTM_HIDDEN)
    model = lstm.build_cell(LSTM_HIDDEN, LSTM_HIDDEN, params=tree, device=DEVICE)
    cpu = lstm.build_cell(LSTM_HIDDEN, LSTM_HIDDEN, params=tree, device="cpu")
    rng = np.random.default_rng(4)
    xs = list(enumerate(rng.uniform(-1, 1, (LSTM_STEPS, LSTM_HIDDEN)).astype(np.float32)))
    state = {}

    def during(p):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS})
        h = c = torch.zeros(LSTM_HIDDEN, device=DEVICE)
        eager = []
        with torch.inference_mode():
            for _, x in xs:
                h, c = be.eager(h, c, torch.from_numpy(x))
                eager.append(h)
        state["eager"] = eager
        return p

    GLOBAL_REPO.reset()
    run_lstm(nns, torch, np, xs[:8], model)  # CUDA context, cuBLAS handles
    GLOBAL_REPO.reset()
    K.reset_launches()
    hs, arrivals, p, _ = run_lstm(nns, torch, np, xs, model, during=during)
    stats = state["stats"]
    print(f"config 4 over {LSTM_STEPS} steps: backend {stats}, wrapper launches "
          f"{state['launches']}", flush=True)
    check(all(h.device.type == torch.device(DEVICE).type for h in hs), "h left the card")
    for i, (g, w) in enumerate(zip(hs, state["eager"])):
        check(bitwise_equal(torch, g, w), f"step {i}: h differs from the eager cell")
    h = c = torch.zeros(LSTM_HIDDEN)
    cpu_hs = []
    with torch.inference_mode():
        for _, x in xs:
            h, c = cpu(h, c, torch.from_numpy(x))
            cpu_hs.append(h)

    def tf32_cell():
        h = c = torch.zeros(LSTM_HIDDEN, device=DEVICE)
        out = []
        with torch.inference_mode():
            for _, x in xs:
                h, c = model(h, c, torch.from_numpy(x).to(DEVICE))
                out.append(h.cpu())
        return out

    def err(got):
        return max(float((g.cpu() - w).abs().max()) for g, w in zip(got, cpu_hs))

    tf32_hs = with_tf32(torch, tf32_cell)
    cpu_err, tf32_err = err(hs), err(tf32_hs)
    tf32_used = not all(bitwise_equal(torch, a, b.cpu()) for a, b in zip(tf32_hs, hs))
    check(cpu_err <= LSTM_CPU_ATOL, f"config 4: h differs from the CPU forward by {cpu_err}")
    check(not tf32_used or tf32_err > LSTM_CPU_ATOL,
          f"config 4: with TF32 on, h is within {tf32_err} of the CPU forward: the tolerance "
          f"{LSTM_CPU_ATOL} misses TF32")
    tf32_note = "rejected" if tf32_used else "the products did not change: no TF32 here"
    res = dict(steps=LSTM_STEPS, replays=stats["replays"],
               **rates(arrivals[:-1], np, end=arrivals[-1]),
               cpu_abs_err=cpu_err, tf32_abs_err=tf32_err, capture_s=stats["capture_s"],
               warmup_s=stats["warmup_s"])
    res["steps_per_s"] = res.pop("fps")
    print(f"config 4: h bitwise equal to the eager cell fed the same states on {LSTM_STEPS} "
          f"steps; within {cpu_err:.3g} of the port's CPU forward (tolerance {LSTM_CPU_ATOL}; "
          f"with TF32 on, {tf32_err:.3g}: {tf32_note})", flush=True)

    # A traced run: the copies tracer and CUPTI's copy records on the cycle.
    GLOBAL_REPO.reset()
    _, _, tp, tr = run_lstm(nns, torch, np, xs[:PROFILED], model, tracers=("copies",),
                            traced=True)
    copy_count = sum(v["copies"] for v in tp.stats()["tracers"]["copies"]["elements"].values())
    kinds = memcpy_counts(tr["count_by_name"])
    launches = tr["calls"].get("cudaGraphLaunch", 0) + tr["calls"].get("cuGraphLaunch", 0)
    check(launches == PROFILED, f"{launches} graph launches for {PROFILED} steps")
    recurrence_checks(stats, LSTM_STEPS, copy_count, kinds["DtoH"])
    busy = tr["busy_ms"] / PROFILED
    res.update(device_busy_ms_per_step=busy,
               device_idle_share=1 - busy * res["steps_per_s"] / 1e3,
               host_ops_per_step=host_ops(tr["calls"]) / PROFILED,
               device_records_per_launch=max(t for _, t in tr["per_launch"]),
               copies_per_step={k: v / PROFILED for k, v in kinds.items()},
               copies_tracer=copy_count)
    for key in ("steps_per_s", "p50_ms", "p90_ms", "device_busy_ms_per_step",
                "device_idle_share", "host_ops_per_step", "device_records_per_launch",
                "copies_per_step", "capture_s"):
        print(f"  config 4 {key}: {res[key]} [{card}]", flush=True)

    # Stop after 100 steps, checkpoint, restore into a new pipeline, 100 more.
    half = LSTM_STEPS // 2
    GLOBAL_REPO.reset()
    first, _, p1, _ = run_lstm(nns, torch, np, xs[:half], model)
    path = os.path.join(work, "lstm_checkpoint.npz")
    ck = checkpoint_pipeline(p1, path)
    check(all(ck["repo"][str(s)]["frame"] is not None for s in LSTM_SLOTS),
          "the checkpoint holds no state of the cycle")
    GLOBAL_REPO.reset()
    rstate = {}

    def rduring(p):
        rstate["stats"] = dict(p["f"].backend.stats)

    rest, _, _, _ = run_lstm(nns, torch, np, xs[half:], model, during=rduring,
                             restore=lambda p: restore_pipeline(p, path))
    check(rstate["stats"]["captures"] == 1, f"the restored run recaptured: {rstate['stats']}")
    for i, (g, w) in enumerate(zip(first + rest, hs)):
        check(bitwise_equal(torch, g, w), f"step {i}: the resumed run differs from the "
                                          "uninterrupted one")
    print(f"config 4: stopped after {half} steps, checkpointed ({os.path.getsize(path)} B), "
          f"restored into a new pipeline and run {LSTM_STEPS - half} more: all {LSTM_STEPS} h "
          "bitwise equal to the uninterrupted run", flush=True)
    GLOBAL_REPO.reset()

    # Config 4b: whole windows, one capture of the 128-step loop.
    seq = lstm.build_sequence(SEQ_WIDTH, SEQ_WIDTH, seq_len=SEQ_LEN, seed=0, device=DEVICE)
    seq_cpu = lstm.build_sequence(SEQ_WIDTH, SEQ_WIDTH, seq_len=SEQ_LEN, seed=0, device="cpu")
    windows = [np.random.default_rng(100 + i).standard_normal((SEQ_LEN, SEQ_WIDTH))
               .astype(np.float32) for i in range(SEQ_WINDOWS)]
    sdesc = ("datasrc name=s ! tensor_upload name=u ! queue max-size-buffers=16 ! "
             "tensor_filter framework=torch name=f ! tensor_sink name=out")
    sstate = {}

    def feed(n):
        def setup(p):
            p["s"].data = [torch.from_numpy(w) for w in windows[:n]]
        return setup

    def sduring(p):
        torch.cuda.synchronize()
        sstate["end"] = time.perf_counter()  # the card's end of the last window
        be = p["f"].backend
        sstate["stats"] = dict(be.stats)
        captured_against_eager(torch, be, [torch.from_numpy(w) for w in windows[:4]],
                               exact=True)

    run_pipeline(nns, sdesc, seq, WARMUP_FRAMES, setup=feed(WARMUP_FRAMES))
    got = []
    _, arrivals, _ = run_pipeline(nns, sdesc, seq, SEQ_WINDOWS, during=sduring, got=got,
                                  setup=feed(SEQ_WINDOWS))
    got = [f.tensor(0) for f in got]
    s_stats = sstate["stats"]
    check(s_stats["captures"] == 1 and s_stats["replays"] == SEQ_WINDOWS,
          f"config 4b: expected one capture and {SEQ_WINDOWS} replays: {s_stats}")
    with torch.inference_mode():
        seq_want = [seq_cpu(torch.from_numpy(w)) for w in windows[:SEQ_CPU_WINDOWS]]
        seq_tf32 = with_tf32(torch, lambda: [seq(torch.from_numpy(w).to(DEVICE)).cpu()
                                             for w in windows[:SEQ_CPU_WINDOWS]])

    def seq_error(outs):
        return max(float((g.cpu() - w).abs().max()) for g, w in zip(outs, seq_want))

    seq_err, seq_tf32_err = seq_error(got), seq_error(seq_tf32)
    check(seq_err <= SEQ_CPU_ATOL, f"config 4b differs from the CPU forward by {seq_err}")
    check(seq_tf32_err > SEQ_CPU_ATOL, f"config 4b: with TF32 on, within {seq_tf32_err} of the "
                                       f"CPU forward: the tolerance {SEQ_CPU_ATOL} misses TF32")
    s_res = dict(windows=SEQ_WINDOWS, replays=s_stats["replays"],
                 **rates(arrivals, np, sstate["end"]),
                 cpu_abs_err=seq_err, tf32_abs_err=seq_tf32_err, capture_s=s_stats["capture_s"])
    s_res["windows_per_s"] = s_res.pop("fps")
    s_res["steps_per_s"] = s_res["windows_per_s"] * SEQ_LEN
    tr = traced_run(nns, sdesc, seq, PROFILED, setup=feed(PROFILED))
    launches = tr["calls"].get("cudaGraphLaunch", 0) + tr["calls"].get("cuGraphLaunch", 0)
    check(launches == PROFILED, f"config 4b: {launches} graph launches for {PROFILED} windows")
    busy = tr["busy_ms"] / PROFILED
    s_res.update(device_busy_ms_per_window=busy,
                 device_idle_share=1 - busy * s_res["windows_per_s"] / 1e3,
                 host_ops_per_window=host_ops(tr["calls"]) / PROFILED,
                 device_records_per_launch=max(t for _, t in tr["per_launch"]))
    print(f"config 4b: replays bitwise equal to eager on 4 windows; within {seq_err:.3g} of "
          f"the CPU forward on {SEQ_CPU_WINDOWS} (tolerance {SEQ_CPU_ATOL}; with TF32 on, "
          f"{seq_tf32_err:.3g}: rejected)", flush=True)
    for key in ("windows_per_s", "steps_per_s", "p50_ms", "p90_ms", "device_busy_ms_per_window",
                "device_idle_share", "host_ops_per_window", "device_records_per_launch",
                "capture_s"):
        print(f"  config 4b {key}: {s_res[key]} [{card}]", flush=True)
    return (state["launches"], res), s_res


# The batch phase (configs 5 and 1d).  Config 5 runs BATCH_ROUNDS rounds of
# N streams, N in BATCH_STREAMS (the float model at 4, bench's default
# streams; the int8 head at 8); config 1d DYN_FRAMES frames through
# tensor_dynbatch max_batch=DYN_MAX_BATCH with every bucket captured before
# PLAYING.  A batched row is held to the batch-1 forward of its frame within
# BATCH_LOGIT_REL of the frame's largest logit (two bf16 steps: a batch may
# sum its convs in other tiles), the int8 head within BATCH_INT8_LOGIT_REL
# (its one activation scale a batch moves every activation's rounding), top-1
# equal.  On the H100 the sound readings were 0.0 (float head) and 0.0081
# (int8 head), the control (a row against another frame's batch-1 forward)
# 0.087 and 0.075 at the least.  The uniform-noise frames share their top-1
# label through the seed-0 weights (the phase prints how many labels there
# are), so the limit is what tells two rows swapped apart, and batch1_check
# fails if the control does not lie beyond it.
BATCH_STREAMS = (4, 8)
BATCH_ROUNDS = 24
BATCH_M = (2, 4, 8, 16, 32)
BATCH_LOGIT_REL = 1 / 128
BATCH_INT8_LOGIT_REL = 1 / 32
DYN_FRAMES = 96
DYN_MAX_BATCH = 8
# config 1d's coverage run: made-up bursts (no traffic source behind them)
# that reach buckets 1 to 4, so that int8_matmul runs at every M in the trace
DYN_BURSTS = (1, 3, 8, 2, 5, 8, 4, 7, 6)
DYN_BURST_GAP_S = 0.008
FENCE_ROUNDS = 4
FENCE_HOLD_CYCLES = 100_000_000


def batch_kernel_phase(torch, np, K, ops, jax_pkg):
    """The kernels at the batch phase's shapes, held against their plain
    versions and timed beside their bounds: ``int8_matmul`` at M in
    BATCH_M x (1280, CLASSES) (the split-K branch's MT 1 to 16 and the
    tiled branch), beside ``torch._int_mm`` at the same M, and
    ``fused_arith``'s normalize at (N, 224, 224, 3) for N in
    BATCH_STREAMS."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    mm_rows = {}
    k, n = 1280, CLASSES
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    ws = torch.from_numpy((rng.random((1, n)) * 0.01 + 1e-4).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    wp = torch.zeros((k, -(-n // 8) * 8), dtype=torch.int8, device=dev)
    wp[:, :n] = wq
    for m in BATCH_M:
        xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
        xs = torch.tensor(np.float32(0.01), device=dev)
        acc = K.int8_matmul(xq, wq, torch.tensor(1.0, device=dev), torch.ones(1, n, device=dev),
                            None)
        exact = xq.cpu().to(torch.int64) @ wq.cpu().to(torch.int64)
        check(int(exact.abs().max()) < 2 ** 24, "the int32 check needs |acc| < 2**24")
        torch.cuda.synchronize()
        check(torch.equal(acc.cpu().to(torch.int64), exact),
              f"int8_matmul ({m},{k},{n}): int32 accumulator not exact")
        got, want = K.int8_matmul(xq, wq, xs, ws, b), K.int8_matmul_plain(xq, wq, xs, ws, b)
        torch.cuda.synchronize()
        ulps = max_ulp(got, want)
        check(ulps <= 1, f"int8_matmul ({m},{k},{n}): {ulps} ulp from its plain version")
        xp = torch.zeros((max(m, 32), k), dtype=torch.int8, device=dev)  # _int_mm: M > 16
        xp[:m] = xq
        t_bytes, by = bound_ms(m * k + k * n + 4 + 8 * n + 4 * m * n, 2 * m * k * n, "int8")
        geo = K.int8_matmul_geometry(m, k, n)
        row = timed(dict(shape=f"({m},{k})x({k},{n})", branch=geo.branch, ulps=ulps,
                         max_abs_err=float((got - want).abs().max()), bound_ms=t_bytes,
                         bound_by=by),
                    kernel=lambda xq=xq, xs=xs: K.int8_matmul(xq, wq, xs, ws, b),
                    plain=lambda xq=xq, xs=xs: K.int8_matmul_plain(xq, wq, xs, ws, b),
                    library=lambda xp=xp: torch._int_mm(xp, wp))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        mm_rows[m] = row
        print(f"int8_matmul ({m},{k},{n}) {geo.branch}: int32 exact, float32 max {ulps} ulp; "
              f"kernel {row['ms']} ms, plain {row['plain_ms']} ms, torch._int_mm "
              f"{row['library_ms']} ms, bound {row['bound_ms']} ms ({by})", flush=True)
    fa_rows = {}
    for nb in BATCH_STREAMS:
        x = torch.from_numpy(rng.integers(0, 256, (nb, IMAGE, IMAGE, 3)).astype(np.uint8)).to(dev)
        got, want = K.fused_arith(x, ops), K.fused_arith_plain(x, ops)
        torch.cuda.synchronize()
        check(bitwise_equal(torch, got, want),
              f"fused_arith {tuple(x.shape)}: not bitwise equal to its plain version")
        e = x.numel()
        t_bytes, by = bound_ms(e * 1 + e * 4, e * 2, "float32")
        row = timed(dict(shape=f"{tuple(x.shape)} uint8 -> float32, '{NORMALIZE}'",
                         bound_ms=t_bytes, bound_by=by),
                    kernel=lambda x=x: K.fused_arith(x, ops),
                    plain=lambda x=x: K.fused_arith_plain(x, ops))
        row["cast_ms"] = device_ms(lambda x=x: x.to(torch.float32), activities=1)[0]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        fa_rows[nb] = row
        print(f"fused_arith {row['shape']}: bitwise equal; kernel {row['ms']} ms, plain "
              f"{row['plain_ms']} ms, cast {row['cast_ms']} ms, bound {row['bound_ms']} ms "
              f"({row['share_of_bound']} of it)", flush=True)
    return mm_rows, fa_rows


def batch_capture_check(stats, rounds, launches, kernels):
    """One capture, a replay a round, and each path kernel's wrapper called
    only in the pre-capture warm-up calls and the capture."""
    check(stats["captures"] == 1 and stats["replays"] == rounds,
          f"expected one capture and {rounds} replays: {stats}")
    want = {k: (stats["warmup_calls"] + 1 if k in kernels else 0) for k in KERNEL_SYMBOLS}
    check(launches == want, f"wrapper launches {launches}, expected {want}")


def stream_check(np, got, eager_rows, rounds):
    """Each stream got ``rounds`` frames, in order: frame r of stream i is
    row i of round r's eager forward, bit for bit (``eager_rows[r][i]``)."""
    check(sorted(got) == list(range(len(got))), f"streams {sorted(got)}")
    for i, frames in got.items():
        check(len(frames) == rounds, f"stream {i} got {len(frames)} of {rounds} frames")
        for r, x in enumerate(frames):
            check(np.array_equal(x.view(np.uint32), eager_rows[r][i].view(np.uint32)),
                  f"stream {i} round {r}: the replay's row differs from the eager forward of "
                  "the same batch")


def batch1_check(np, rows, single, rel):
    """Batched rows against the batch-1 forward of each frame: within
    ``rel`` of the frame's largest logit, the same top-1 label.  The
    control holds row i to frame j's batch-1 forward (j != i): it must lie
    beyond ``rel``, or the check could not tell two rows swapped.  Returns
    the largest difference and the smallest control, both relative to the
    batch-1 forward's largest logit, and how many distinct top-1 labels
    the batch-1 forwards hold (with one, the label check cannot see a
    swap)."""
    def rel_diff(a, b):
        return float(np.abs(a.astype(np.float64) - b).max() / max(np.abs(b).max(), 1e-30))

    worst = 0.0
    for i, (a, b) in enumerate(zip(rows, single)):
        d = rel_diff(a, b)
        worst = max(worst, d)
        check(d <= rel, f"frame {i}: batched row {d} of its largest logit from the batch-1 "
                        f"forward (tolerance {rel})")
        check(int(np.argmax(a)) == int(np.argmax(b)), f"frame {i}: top-1 differs from batch 1")
    control = min(rel_diff(a, b) for i, a in enumerate(rows)
                  for j, b in enumerate(single) if i != j)
    check(control > rel, f"control: a batched row lies within {control} of another frame's "
                         f"batch-1 forward, inside the tolerance {rel}: a swap would pass")
    return worst, control, len({int(np.argmax(b)) for b in single})


def dyn_checks(np, captures_before, captures_after, report, buckets, pts_out, n_frames):
    """Config 1d: the whole ladder captured before PLAYING and nothing
    after, every frame out once and in pts order.  Returns the histogram
    of the buckets that occurred."""
    ladder = []
    b = 1
    while b <= DYN_MAX_BATCH:
        ladder.append(b)
        b <<= 1
    check(captures_before == len(ladder),
          f"{captures_before} captures before the first frame, expected {len(ladder)}")
    check(captures_after == captures_before,
          f"{captures_after - captures_before} captures while PLAYING")
    check(report is not None and [c["label"] for c in report["compiled"]] ==
          [f"bucket{b}" for b in ladder], f"warmup report {report}")
    check(pts_out == sorted(pts_out) and len(pts_out) == n_frames == len(set(pts_out)),
          f"{len(pts_out)} frames out of {n_frames}, in order: {pts_out == sorted(pts_out)}")
    check(all(b in ladder for b in buckets), f"buckets {sorted(set(buckets))}")
    return {str(b): buckets.count(b) for b in ladder}


def dyn_launch_check(tr, buckets):
    """Config 1d's trace: a graph launch a batch, in the order the batches
    left dynbatch, each with one fused_arith and one int8_matmul record
    (the head at M = that batch's bucket) and no nms_keep.  A launch with
    fewer device records than the fullest launch of its bucket lost them
    in the tracer and may lack as many path records.  Returns the
    int8_matmul records by M."""
    check(len(tr["per_launch"]) == len(buckets),
          f"{len(tr['per_launch'])} graph launches for {len(buckets)} batches")
    full = {}
    for b, (_, total) in zip(buckets, tr["per_launch"]):
        full[b] = max(full.get(b, 0), total)
    by_m = {}
    for i, (b, (rec, total)) in enumerate(zip(buckets, tr["per_launch"])):
        check(rec.get("pallas_nms_keep", 0) == 0 and rec.get("fused_arith", 0) <= 1
              and rec.get("int8_matmul", 0) <= 1, f"graph launch {i} (bucket {b}): {rec}")
        missing = [k for k in ("fused_arith", "int8_matmul") if not rec.get(k)]
        check(len(missing) <= full[b] - total,
              f"graph launch {i} (bucket {b}) holds no record of {missing}")
        by_m[b] = by_m.get(b, 0) + rec.get("int8_matmul", 0)
    check(all(by_m[b] > 0 for b in by_m), f"no int8_matmul record at some M: {by_m}")
    return by_m


def batch_desc(n, ckpt, builder, frames_per_stream=None):
    """Config 5's string: N datasrcs into tensor_mux, tensor_batch, the
    normalize, tensor_upload ! queue, the filter on the checkpoint,
    tensor_unbatch, tensor_demux, N sinks."""
    srcs = " ".join(f"datasrc name=cam{i} ! m.sink_{i}" for i in range(n))
    sinks = " ".join(f"d.src_{i} ! tensor_sink name=out{i}" for i in range(n))
    return (f"tensor_mux name=m sync_mode=nosync ! tensor_batch ! "
            f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
            "tensor_upload name=u ! queue max-size-buffers=16 ! "
            f"tensor_filter framework=torch name=f model={ckpt} "
            f"custom=builder=mobilenet_v2:{builder},batch={n},image_size={IMAGE} ! "
            f"tensor_unbatch ! tensor_demux name=d {srcs} {sinks}")


def dyn_desc():
    return ("datasrc name=s ! tensor_dynbatch name=dyn max_batch="
            f"{DYN_MAX_BATCH} ! tensor_transform mode=arithmetic option={NORMALIZE} "
            "acceleration=pallas ! tensor_upload name=u ! queue max-size-buffers=16 ! "
            "tensor_filter framework=torch name=f ! tensor_dynunbatch ! tensor_sink name=out")


def run_batch(nns, torch, desc, n, frames, setup=None, traced=False, during=None):
    """Config 5 once: ``frames[i]`` into stream i; returns (pipeline, each
    stream's outputs as host numpy, the last sink's arrival times, the
    trace or during's result)."""
    p = nns.parse_launch(desc)
    for i in range(n):
        p[f"cam{i}"].data = list(frames[i])
    got = {i: [] for i in range(n)}
    arrivals = []

    def on_frame(f, i):
        got[i].append(f.tensor(0).numpy())
        if i == n - 1:
            arrivals.append(time.perf_counter())

    for i in range(n):
        p[f"out{i}"].connect("new-data", lambda f, i=i: on_frame(f, i))
    if setup is not None:
        setup(p)
    result = None
    if traced:
        gate = p["u"]._lock
        gate.acquire()
        try:
            p.start()
        except BaseException:
            gate.release()
            raise
        try:
            result = trace(lambda: (time.sleep(0.25), gate.release(),
                                    check(p.wait(600), "traced run did not finish")))
        finally:
            p.stop()
    else:
        p.start()
        try:
            check(p.wait(600), f"config 5 did not finish: {desc}")
            result = during(p) if during is not None else None
        finally:
            p.stop()
    return p, got, arrivals, result


def batch_phase(torch, np, K, ops, root, card):
    """Config 5 at N=4 (float) and N=8 (int8 head), config 1d with every
    bucket captured before PLAYING, and the pool's fence under a held
    upload stream."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch import pool as P
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tree = mobilenet_v2.init_tree(0, CLASSES, 1.0)
    ckpt = os.path.join(work, "mobilenet_v2_batch.npz")
    save_state(tree, ckpt)
    rng = np.random.default_rng(12)
    out = {}

    def frames_for(n, rounds):
        return [[Frame.of(torch.from_numpy(rng.integers(0, 256, (IMAGE, IMAGE, 3),
                                                        dtype=np.uint8)), pts=r)
                 for r in range(rounds)] for _ in range(n)]

    for n, builder, rel, kernels in ((BATCH_STREAMS[0], "build", BATCH_LOGIT_REL,
                                      ("fused_arith",)),
                                     (BATCH_STREAMS[1], "build_quantized,int8_head=1",
                                      BATCH_INT8_LOGIT_REL, ("fused_arith", "int8_matmul"))):
        name = f"config 5, {n} streams{', int8 head' if 'int8' in builder else ''}"
        desc = batch_desc(n, ckpt, builder)
        frames = frames_for(n, BATCH_ROUNDS)
        state = {}

        def during(p, frames=frames, n=n):
            be = p["f"].backend
            state.update(stats=dict(be.stats),
                         launches={k.__name__: k.launches for k in K.KERNELS},
                         folded=not any(type(x).__name__ == "TensorTransform"
                                        for x in p.nodes.values()))
            rows = []
            with torch.inference_mode():
                for r in range(BATCH_ROUNDS):
                    x = torch.stack([frames[i][r].tensor(0) for i in range(n)]).cuda()
                    rows.append(be.eager(x)[0].cpu().numpy())
            state["eager"] = rows

        run_batch(nns, torch, desc, n, frames_for(n, 2))  # the kernels' one-time work
        K.reset_launches()
        t0 = time.perf_counter()
        p, got, arrivals, _ = run_batch(nns, torch, desc, n, frames, during=during)
        wall = time.perf_counter() - t0
        check(state["folded"], f"{name}: the normalize did not fold into the filter")
        batch_capture_check(state["stats"], BATCH_ROUNDS, state["launches"], kernels)
        stream_check(np, got, state["eager"], BATCH_ROUNDS)
        if "int8" in builder:
            single = mobilenet_v2.build_quantized(params=tree, int8_head=True,
                                                  image_size=IMAGE, device=DEVICE)
        else:
            single = mobilenet_v2.build(params=tree, image_size=IMAGE, device=DEVICE)
        with torch.inference_mode():
            xs = [K.fused_arith(frames[i][r].tensor(0).cuda(), ops)
                  for r in range(2) for i in range(n)]
            one = [single(x).float().cpu().numpy() for x in xs]
        worst, control, labels = batch1_check(
            np, [got[i][r] for r in range(2) for i in range(n)], one, rel)
        r = rates(arrivals, np)
        res = dict(streams=n, rounds=BATCH_ROUNDS, replays=state["stats"]["replays"],
                   fps=r["fps"], frames_per_s=r["fps"] * n, p50_ms=r["p50_ms"],
                   p90_ms=r["p90_ms"], wall_s=wall, capture_s=state["stats"]["capture_s"],
                   batch1_rel=worst, batch1_control=control, batch1_top1_labels=labels, launches=state["launches"])
        tr = profile_path(lambda m: run_batch(nns, torch, desc, n, frames_for(n, m),
                                              traced=True)[3], res, kernels)
        res["device_records_per_launch"] = quant_checks(tr, 0, kernels)
        res["frames_per_s"] = res["fps"] * n
        print(f"{name}: {BATCH_ROUNDS} rounds through parse_launch, one capture, "
              f"{res['replays']} replays; every stream's rows equal the eager forward of "
              f"the same batch bit for bit; rows within {worst} of the batch-1 forward's "
              f"largest logit (tolerance {rel}; another frame's forward at {control} at the "
              f"least), top-1 equal ({labels} distinct top-1 labels) [{card}]", flush=True)
        print(f"  {name}: {res['frames_per_s']} frames/s over all streams, {res['fps']} "
              f"rounds/s, device busy {res['device_busy_ms_per_frame']} ms a round, idle share "
              f"{res['device_idle_share']}, host-issued operations {res['host_ops_per_frame']} "
              f"a round [{card}]", flush=True)
        out[f"config5_n{n}"] = res

    # -- config 1d: dynbatch, every bucket captured before PLAYING -----------
    base = mobilenet_v2.build_quantized(params=tree, int8_head=True, image_size=IMAGE,
                                        device=DEVICE)
    poly = TorchModel(apply=base.apply, params=base.params, name="mobilenet_v2_poly_int8_head",
                      input_spec=TensorsSpec.of(TensorSpec(np.float32, (None, IMAGE, IMAGE, 3))),
                      output_spec=TensorsSpec.of(TensorSpec(np.float32, (None, CLASSES))),
                      device=DEVICE)
    dyn_frames = [torch.from_numpy(rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8))
                  for _ in range(DYN_FRAMES)]
    os.environ["NNSTPU_COMPILE_WARMUP"] = "1"
    try:
        state = {"batches": []}

        def setup(p):
            p["s"].data = [Frame.of(x, pts=i) for i, x in enumerate(dyn_frames)]
            p["f"].model = poly
            dyn = p["dyn"]
            push = dyn.push

            def recording_push(frame, pad_name=None):
                state["batches"].append((list(frame.meta["dynbatch"]["pts"]),
                                         int(frame.tensors[0].shape[0])))
                push(frame, pad_name)

            dyn.push = recording_push

        def dyn_run(traced=False, bursty=False):
            state["batches"] = []
            p = nns.parse_launch(dyn_desc())
            setup(p)
            if bursty:  # the coverage run: bursts of DYN_BURSTS frames, gaps between
                src, frames = p["s"], p["s"].frames

                def bursts():
                    it = iter(frames())
                    for k in itertools.cycle(DYN_BURSTS):
                        chunk = list(itertools.islice(it, k))
                        if not chunk:
                            return
                        yield from chunk
                        time.sleep(DYN_BURST_GAP_S)

                src.frames = bursts
            got = []
            arrivals = []
            p["out"].connect("new-data", lambda f: (got.append((f.pts, f.tensor(0).numpy())),
                                                    arrivals.append(time.perf_counter())))
            gate = p["u"]._lock
            gate.acquire()
            try:
                p.start()
            except BaseException:
                gate.release()
                raise
            be = p["f"].backend
            before = be.stats["captures"]
            tr = None
            try:
                if traced:
                    tr = trace(lambda: (gate.release(),
                                        check(p.wait(600), "traced run did not finish")))
                else:
                    gate.release()
                    check(p.wait(600), "config 1d did not finish")
                launches = {k.__name__: k.launches for k in K.KERNELS}  # before eager
                eager = {}
                with torch.inference_mode():
                    for pts, b in state["batches"]:
                        x = torch.stack([dyn_frames[i] for i in pts] +
                                        [dyn_frames[pts[-1]]] * (b - len(pts))).cuda()
                        eager[tuple(pts)] = be.eager(x)[0].cpu().numpy()
                after = be.stats["captures"]
                report = p.warmup_report
            finally:
                p.stop()
            buckets = [b for _, b in state["batches"]]
            hist = dyn_checks(np, before, after, report, buckets, [pts for pts, _ in got],
                              DYN_FRAMES)
            by_pts = dict(got)
            for pts, b in state["batches"]:
                for j, f in enumerate(pts):
                    check(np.array_equal(by_pts[f].view(np.uint32),
                                         eager[tuple(pts)][j].view(np.uint32)),
                          f"config 1d frame {f} (bucket {b}): the replay's row differs from "
                          "the eager forward of the same rows")
            return hist, buckets, arrivals, before, report, tr, launches

        dyn_run()  # the kernels' one-time work
        K.reset_launches()
        hist, buckets, arrivals, before, report, _, launches = dyn_run()
        check(launches["fused_arith"] > 0 and launches["int8_matmul"] > 0
              and launches["pallas_nms_keep"] == 0, f"config 1d wrapper launches {launches}")
        r = rates(arrivals, np)
        res = dict(frames=DYN_FRAMES, batches=len(buckets), buckets=hist, fps=r["fps"],
                   p50_ms=r["p50_ms"], p90_ms=r["p90_ms"], captures_before_playing=before,
                   warmup_s=report["seconds"], launches=launches)
        bhist, bbuckets, _, _, _, tr, _ = dyn_run(traced=True, bursty=True)
        by_m = dyn_launch_check(tr, bbuckets)
        res.update(coverage=dict(bursts=DYN_BURSTS, gap_s=DYN_BURST_GAP_S, buckets=bhist,
                                 int8_matmul_records_by_m={str(m): c
                                                           for m, c in sorted(by_m.items())},
                                 device_busy_ms_per_batch=tr["busy_ms"] / len(bbuckets),
                                 host_ops_per_batch=host_ops(tr["calls"]) / len(bbuckets)))
    finally:
        os.environ.pop("NNSTPU_COMPILE_WARMUP", None)
    b = res["coverage"]
    print(f"config 1d: {DYN_FRAMES} frames, {before} captures before the first frame (warmup "
          f"{res['warmup_s']} s) and none while PLAYING; every frame out in pts order; each "
          f"batch's rows equal the eager forward of the same rows bit for bit; buckets {hist}, "
          f"{res['fps']} frames/s [{card}]", flush=True)
    print(f"  config 1d's coverage run (made-up bursts {DYN_BURSTS}, {DYN_BURST_GAP_S} s "
          f"apart): buckets {b['buckets']}, int8_matmul records by M in the trace "
          f"{b['int8_matmul_records_by_m']}; device busy {b['device_busy_ms_per_batch']} ms a "
          f"batch, host-issued operations {b['host_ops_per_batch']} a batch [{card}]",
          flush=True)
    out["config1d"] = res

    # -- the pool's fence: a recycled lease is not rewritten under its copy --
    n = BATCH_STREAMS[0]
    frames = frames_for(n, FENCE_ROUNDS)
    waited = []

    def hold(p):
        u = p["u"]
        upload = u.process

        def held_upload(pad, frame):
            with torch.cuda.stream(u._stream):
                torch.cuda._sleep(FENCE_HOLD_CYCLES)
            return upload(pad, frame)

        u.process = held_upload

    pool = P.default_pool()
    wait = pool._wait_fences

    def counting_wait(raw):
        events = list(pool._fences.get(id(raw), ()))
        waited.append(sum(not e.query() for e in events))
        wait(raw)

    pool._wait_fences = counting_wait
    hits = pool.stats()["hits"]
    state = {}

    def fence_during(p):
        be = p["f"].backend
        with torch.inference_mode():
            state["eager"] = [be.eager(torch.stack([frames[i][r].tensor(0) for i in range(n)])
                                       .cuda())[0].cpu().numpy() for r in range(FENCE_ROUNDS)]

    try:
        _, got, _, _ = run_batch(nns, torch, batch_desc(n, ckpt, "build"), n, frames,
                                 setup=hold, during=fence_during)
    finally:
        pool._wait_fences = wait
    stream_check(np, got, state["eager"], FENCE_ROUNDS)
    reused = pool.stats()["hits"] - hits
    check(reused >= FENCE_ROUNDS - 1 and sum(waited) > 0,
          f"the pool reused {reused} leases and waited on {sum(waited)} copies in flight")
    out["fence"] = dict(rounds=FENCE_ROUNDS, leases_reused=reused,
                        copies_in_flight_waited=sum(waited), hold_cycles=FENCE_HOLD_CYCLES)
    print(f"pool fence: config 5 with the upload's stream held {FENCE_HOLD_CYCLES} cycles "
          f"before each copy; {reused} leases reused, {sum(waited)} waits on a copy still in "
          "flight, every round's rows equal the eager forward of its own frames", flush=True)
    return out


def _conv_dicts(tree):
    """Every dict of a params tree that holds a weight ``"w"``, in order."""
    if isinstance(tree, dict):
        return ([tree] if "w" in tree else []) + [d for v in tree.values()
                                                 for d in _conv_dicts(v)]
    if isinstance(tree, list):
        return [d for v in tree for d in _conv_dicts(v)]
    return []


def main() -> int:
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
    # fused_arith: 18 instantiations (9 float32-chain, 9 general), summed up
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
    ops = bind(NORMALIZE, np.dtype(np.uint8))
    kernels["int8_matmul"]["at_m"], kernels["fused_arith"]["at_batch"] = batch_kernel_phase(
        torch, np, K, ops, jax_pkg)
    audio_ops = bind(AUDIO_NORMALIZE, np.dtype(np.int16))
    in_graph = graph_kernel_phase(torch, np, K, ops, audio_ops, bind)
    slices = {}
    by_path = {"image_labeling": slice_phase(torch, np, K, ops, root, card, slices)}
    by_path["object_detection"] = detection_phase(torch, np, K, ops, root, card, slices)
    observed = obs_phase(torch, np, slices, root, card)
    by_path["audio"] = audio_phase(torch, np, K, audio_ops, root, card)
    upload_wait = upload_wait_phase(torch, np)
    by_path["model_file"] = model_file_phase(torch, np, K, ops, root, card)
    torchscript = torchscript_phase(torch, np, K, ops, root)
    drift = drift_phase(torch, np, K, ops, bind)
    custom_so = custom_so_phase(torch, np, root)
    by_path["quant"], by_path["quant_int8_head"], by_path["quant_ssd"] = quant_phase(
        torch, np, K, ops, root, card, by_path["image_labeling"][1]["device_busy_ms_per_frame"])
    t1 = time.perf_counter()
    by_path["pose"], pose_heatmaps, pose_int8 = pose_phase(torch, np, K, ops, root, card)
    t2 = time.perf_counter()
    by_path["lstm"], lstm_seq = recurrence_phase(torch, np, K, root, card)
    t3 = time.perf_counter()
    batched = batch_phase(torch, np, K, ops, root, card)
    for key in ("config5_n4", "config5_n8", "config1d"):
        by_path[key] = (batched[key]["launches"], batched[key])
    print(f"phase wall s: up to the quant phase {t1 - t0:.3f}, pose {t2 - t1:.3f}, "
          f"recurrence {t3 - t2:.3f}, batch {time.perf_counter() - t3:.3f}", flush=True)
    wrapper = {"fused_arith": "fused_arith", "int8_matmul": "int8_matmul",
               "nms_keep": "pallas_nms_keep"}
    for name, r in kernels.items():
        counts = {path: launches[wrapper[name]] for path, (launches, _) in by_path.items()}
        r["launches"] = sum(counts.values())
        r["launches_by_path"] = counts
        check(r["launches"] > 0, f"{name} never launched on a main path")
    print(json.dumps({"card": card, "build_s": build_s, "kernels_in_a_graph": in_graph,
                      "slice": by_path["image_labeling"][1],
                      "slice2": by_path["object_detection"][1],
                      "audio": by_path["audio"][1], "upload_wait": upload_wait,
                      "model_file": by_path["model_file"][1], "torchscript": torchscript,
                      "drift": drift, "custom_so": custom_so, "obs": observed,
                      "quant": by_path["quant"][1], "quant_int8_head": by_path["quant_int8_head"][1],
                      "quant_ssd": by_path["quant_ssd"][1], "pose": by_path["pose"][1],
                      "pose_heatmaps": pose_heatmaps, "pose_int8": pose_int8,
                      "lstm": by_path["lstm"][1], "lstm_seq": lstm_seq,
                      "config5_n4": batched["config5_n4"], "config5_n8": batched["config5_n8"],
                      "config1d": batched["config1d"], "pool_fence": batched["fence"]}),
          flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

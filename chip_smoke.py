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
   bit says, a conversion LLVM folds marking none of its own (C13: ROADMAP
   C13's input chain, two probed classes and an int8 lane wrapped to its
   maximum before a folded conversion, their reset bits checked on the
   host); then ``int8_matmul`` at M = 2, 4, 8,
   16 (split-K) and 32 (tiled) x (1280, 1001), exact in int32 and within
   1 ulp, and ``fused_arith``'s normalize at (4, 224, 224, 3) and (8, 224,
   224, 3) (config 5) and at (1, 2 and 4, 300, 300, 3) (config 2c's
   dynbatch buckets), bitwise, each timed beside its bound (``int8_matmul``
   beside ``torch._int_mm`` at the same M).
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
18. cascade phase (config 2c): ``leg_config2c``'s model, SSD-MobileNet-v2
   1.0 (300x300, 91 labels, seed 0) with ``decode_topk`` k=16, each box
   resampled to 96x96 (``cascade.crop_and_resize``) and classified by
   MobileNet-v2 1.0 (1001 classes, seed 1), bf16, named by its checkpoint
   in ``videotestsrc ! tensor_converter !`` the normalize ``! tensor_upload
   ! queue ! tensor_filter model=<npz> custom=builder=cascade:
   build_detect_classify,... ! tensor_sink``, 64 frames: the normalize
   folds into the cascade's capture (``fused_arith`` called only in the
   warm-up calls and the capture), one capture, a replay a frame, the
   replays equal to the model called eagerly on the plain chain's output
   (bitwise or within CASCADE_REPLAY_REL); on 4 frames the replays against
   the port's CPU run (``cascade_check`` against the CPU detector's whole
   ranking, read through ``ssd_mobilenet.rank_anchors`` as the model reads
   it: each row the decode of the CPU's anchor at that rank or of one whose
   score lies within the margin of it, boxes, classes, logits and top-1
   labels within CASCADE_CPU_LIMITS); a 16-frame trace (one
   ``fused_arith`` record a graph launch).  Then its dynbatch form
   (``tensor_dynbatch max_batch=4``, every bucket captured before PLAYING,
   32 frames, rows against the eager batch on the plain chain, and each
   row against its frame's batch-1 cascade on the card under
   CASCADE_BATCH1_LIMITS, with a control that holds row i to frame i + 1
   and must be refused) and ``examples/pipelines/crop_cascade.py``'s
   element cascade (tee, a detector filter, ``tensor_crop size=16:16
   num=2``, a classifier filter; torch stubs) bit for bit against the same
   run on the CPU;
19. app phase: ``PipelineHandle`` on ``appsrc ! `` the normalize ``!
   tensor_upload ! queue ! valve ! tensor_filter`` (slice 1's model with
   the int8 head, from a checkpoint) ``! output-selector`` into two sinks:
   32 frames pushed, 8 of them while the valve is closed (dropped), the
   selector switched halfway, each sink's pts checked; ``SingleShot`` on
   the same model and normalized frames, half directly and half with a
   timeout (on its worker thread), its logits equal to the pipeline's
   (bitwise or within APP_REL); the same invoke through the C ABI
   (``libnnstreamer_tpu_torch_capi.so``, built with ``g++``, loaded with
   ctypes) giving SingleShot's bytes; the CLI (``python -m
   nnstreamer_tpu_torch``) as a subprocess on an 8-frame string: exit 0,
   its report lines;
20. ViT phase: ViT-B/16 (224x224, patch 16, width 768, 12 heads, 12
   layers, MLP 3072, 1000 classes, bf16, seed-0 weights from the port's
   numpy init) handed to the filter of slice 1's string, 64 frames: one
   capture, a replay a frame, ``fused_arith`` called only in the capture's
   warm-up calls and the capture (the other kernels never), the replays
   equal to eager bit for bit, the card's logits within VIT_LOGIT_REL of
   the port's CPU forward of the same params on VIT_CPU_FRAMES frames with
   the same top-1 (``vit_cpu_check``); the 16-frame trace (one
   ``fused_arith`` record a launch), and the model's FLOPs a frame from its
   shapes over the busy time (TFLOP/s, the share of the bf16 peak); then
   the W8A8 form (``vit.build_quantized``, every trunk matmul on
   ``torch._int_mm``), 16 frames, the same checks against its own eager
   run;
21. config 4c: bench.py's DECODE_CELL (``transformer.build_decode_cell``,
   float32) in the repo-slot cycle of ``run_kvdecode_fps`` (a data source
   for x_t, repo sources 92 and 93 for the cache and the position on the
   card, ``tensor_mux sync-mode=nosync``, the filter, ``tensor_demux``,
   the sink and two repo sinks), 120 steps: one capture, the outputs
   finite and bit for bit the eager decode loop's on the card, within
   DECODE_REL of the port's CPU cell on 8 steps, and a 16-step trace with
   no device-to-host copy (CUPTI and the ``copies`` tracer);
22. config 4d: ``ContinuousBatcher(capacity=8)`` over the same cell, its
   step one CUDA graph and each prefill bucket one (``warmup_prefill``):
   12 streams joining 2 steps apart, 16 steps each (all 8 slots fill, 4
   are reused), each bit for bit the same stream served alone in its slot
   and within DECODE_REL of the eager loop; every slot streaming 119 steps
   (aggregate steps a second, ticks: 8 steps a tick), a 16-step trace for
   the busy time a tick; prefill + decode against all-stepwise and
   prefill's tokens a second (119-token prompts); a ``window=True`` stream
   past t_max against the eager ring; and, timing only, the engine at
   ViT-B's trunk width (768 wide, 12 heads, 12 layers, 75.5 MB of cache);
23. recovery phase (self-healing on slice 1's string, its queue named
   ``q``, 64 frames, the filter ``f``): (a) ``invoke_raise@f:every=16``
   under the ``restart`` policy: 60 frames delivered, 4 restarts and 4
   frames shed in ``recovery_stats()``, 5 captures (the first and one a
   restart, each on the filter's thread while the pipeline plays),
   ``fused_arith`` and ``int8_matmul`` launched in each capture's warm-up
   and capture, each label equal to the fault-free run's for the same frame
   and the logits bit for bit (or within 1e-3 relative, a conv algorithm
   picked differently), the device bytes in use after the run within
   POOL_SLACK of their value after the first capture (no graph pool
   leaked), and each restart's wall time from its fault to its recovery
   record; (b) one fault under ``quarantine-passthrough``: the later frames
   shed (the filter's in and out specs differ), delivered + shed ==
   offered; (c) ``compile_raise:count=1``: under ``fail-pipeline`` the start
   raises the injected fault, under ``restart`` every frame is served from
   the card after one restart; (d) ``recover_queue`` on a queue wedged by
   ``queue_wedge`` (every frame drained and counted dropped, the EOS kept,
   the run ends) and ``restart_source`` on a live source after its first
   frames (the restarted stream delivers frames 0 to 63 in order);
24. device-lane phase: the ``device`` tracer on slice 1 and on ViT-B/16
   (the ViT phase's string), 64 frames each and a traced run of 16: one
   ``device_exec`` span a dispatch, reaped == dispatched, no probe dropped,
   each span's CUDA event pair within its enqueue→done time, the mean event
   pair a frame at least 0.9 of CUPTI's busy time a frame in the traced run,
   ``nnstpu_compile_total`` moved as the backend's ``stats``, the busy
   fraction in (0, 1] while playing and 0 after ``stop()`` (``[obs]
   busy_window_s`` 1), ``device_memory_snapshot()``'s ``cuda:0`` entry
   (peak >= in use, ViT's parameter bytes in use); ViT's registry FLOPs
   within 2% of ``vit.flops_per_frame`` and its ``nnstpu_mfu`` at most 1.1
   of the busy-time share of the peak; then the wire probe;
25. lanes phase (the dispatcher lanes and the watchdog): config 5 at 8
   streams with the int8 head, 24 rounds, under ``[dispatch] lanes`` 0, 1
   and auto: each mode's stream and capture checks, no capture while
   PLAYING, every round's rows bit for bit thread mode's, no lane parked
   longer than two polls while a ready ring held work (a sampler of the
   runtime), a traced run under lanes=auto holding ``fused_arith`` and
   ``int8_matmul`` records; slice 1 (64 frames) under lanes=1 and
   lanes=auto, labels and logits bit for bit thread mode's, the device
   tracer's reaper waking the lanes on each completion, and a live source
   promoted to a helper at start; config 1d under lanes=auto, every bucket
   captured before PLAYING; the recovery phase's restart case (a) under
   lanes=2 (60 of 64 frames, 5 captures, the fault-free run's labels);
   then the watchdog with
   ``recover`` in thread mode and under lanes=auto: a wedged queue
   (``/healthz`` 503, ``nnstpu_health`` 0, the stall dump, a drain, 200
   again, delivered + shed == offered), a source that stalls once
   (restarted, its later frames delivered), and a ``torch.cuda._sleep``
   filter past a 0.5 s device deadline (``overdue_device``, a live
   breaker tripped, ``breaker_trip ok``), each with its times from fault to
   verdict and to recovery;
26. profile phase and training phase (a capture window over slice 1,
   ``/profile``, ``profile_auto``, the whole-run trace, the memory ledger;
   MobileNet-v2 1.0 trained at batch 32, then deployed);
27. query phase (serving over the NNSQ wire, loopback): (a) slice 1 split
   at the converter, the normalize and the model behind a ``QueryServer``
   on the ``fragment`` backend (captured by ``warmup`` before any
   request), 64 frames after 4: logits and labels bit for bit the
   in-process slice's, ``fused_arith`` and ``int8_matmul`` launched; (b)
   4 client pipelines of 32 frames through ``QueryServer(batch=4)`` on the
   batch-polymorphic model: every coalesced group bit for bit the
   in-process batched filter on the same rows, every reply its client's
   rows; (c) 8 decode streams (a 119-token prefill, then 8 steps) through a
   ``DecodeServer`` on config 4d's engine within 1e-5 of the engine, and a
   session migrated between two servers through a ``TensorRepoServer``
   within 1e-5 of an unmigrated run; (d) slice 1 offloaded under ``[sched]
   policy=drr`` with a rate (delivered + shed == offered, each shed a typed
   ``QueryOverloadError``) and under ``socket_drop``, ``truncate`` and
   ``corrupt`` on ``nnsq_send``; rates and round trips, the server's invoke
   and its reply's read;
28. C16 phase: ROADMAP C16's order (two trainers' graphs captured on two
   pipelines' threads, both stopped, a profiler window replaying the
   first): it ends in a trace or in ``ProfiledReplayHazard``, never in a
   dead process;
29. stream phase (capture, replay and flow control on slice 1 at full
   width, slice 1's model): (a) 68 ``videotestsrc`` frames captured through
   a tee to ``tensor_decoder mode=protobuf ! filesink`` and to
   ``tensor_save`` (behind ``tensor_demux``: the source's ``VideoSpec`` in
   meta is refused, as by the JAX package), both files read back as the
   frames; (b) ``filesrc ! tensor_converter input-format=protobuf !
   tensor_debug checksum=true !`` the normalize ``! tensor_upload ! queue !
   tensor_filter ! tensor_debug checksum=true ! tensor_if compared-value=max
   ! tensor_rate framerate=20/1 ! tensor_decoder ! tensor_sink``, the
   threshold the median of the in-process run's maxima: one capture (at the
   first frame: the protobuf stream names no geometry), a replay a frame,
   the logits at the filter's tap bit for bit the in-process slice's on the
   same frames, the gate's and the rate's counters and the sink's (pts,
   label) those of a host model of those logits and timestamps, the taps'
   checksums the frames' byte sums, and a 16-frame trace with one
   ``fused_arith`` and one ``int8_matmul`` record a graph launch; (c) the
   same from ``tensor_load``, bit for bit with (b); (d) 64 seeded 512x512
   uint8 class masks (4% non-zero) through ``tensor_sparse_enc ! queue !
   tensor_sparse_dec`` on host tensors and behind ``tensor_upload`` on card
   tensors, twice each (the second timed), bit for bit, with the bytes
   ratio; (e) ``direct_video`` on card
   frames and ``tensor_src_iio`` in continuous mode over a fake sysfs tree
   and a FIFO, each scan against its independent decode;
30. mesh phase (the port's single-controller mesh, ``parallel/``, over
   ``force_device_count(4)``: four shards on the one card; each in-model leg
   also on the real device count, where the modes degenerate): (a) ViT-B/16
   in bfloat16 through slice 1's string with ``attn="ring"``, then
   ``"ulysses"``, over ``sp:4`` (49 tokens and 3 heads a shard), 64 frames
   each: one capture, replays bitwise equal to eager calls, logits within
   1/16 of ``attn="full"`` in the same process with top-1 equal (or decided
   by the margin), a 16-frame trace with one ``fused_arith`` record a graph
   launch; (b) a switch-MoE encoder at Switch-Base-8 widths (768, 12 heads,
   3072, 8 experts, 12 layers; MoE in every block, the encoder alone) on 16
   int16 windows of 512 x 768 through the normalize, over ``ep:4`` and
   unsharded: one capture each, replays bitwise eager, ``ep:4`` within 1/16
   of unsharded with 99% of tokens' argmax equal and the first layer's
   routing exactly equal, the dropped tokens a window; (c)
   ``build_pipelined`` at ViT-B's encoder widths over ``pp:4`` (3 blocks a
   stage), batch 8 of 196 x 768, 4 microbatches, float32, 8 batches, within
   1e-4 of the sequential apply; (d) config 5 at 8 streams with the int8
   head under ``NNSTPU_MESH=dp:4``: a graph a shard in two segments (the
   batch's one activation scale reduced between them), one ``fused_arith``
   and one ``int8_matmul`` record a shard a round, rows bit for bit the
   sharded eager forward and ``torch-sharded``'s, within 1/32 of the
   unsharded filter with top-1 equal, the shards' int8 activations and
   scale bit for bit the whole batch's though the shards' own maxima
   differ; config 1d under the mesh (buckets 4 x {1, 2, 4, 8}, every one
   captured before PLAYING); ``NNSTPU_MESH=auto`` on the real cards (off
   with one); (e) the device tracer on (d)'s ``torch-sharded`` run, one
   series a shard;
31. runs the fleet tier (``fleet_phase``): worker subprocesses
   (``python -m nnstreamer_tpu_torch.fleet worker``, spawned together by
   ``SubprocWorkerFactory``) on the card behind the port's router,
   membership, supervisor and autoscaler, driven by the port's load
   generator.  (a) two workers on the ``fragment`` backend with slice 1's
   normalize and MobileNet-v2 (int8 head), each warming up (``warming``
   until its capture is done); 4 tenants at an open-loop constant rate
   (at least 400 requests) through the router while a seeded
   ``FleetChaos`` ``worker_kill`` takes one worker down: every reply bit
   for bit the in-process slice's on the same frame, offered = delivered
   + shed with shed 0, the dead worker ``down`` in membership and
   respawned into ``up``; the rate, client p50 and p99 from the scheduled
   arrival, spawn-to-routable and respawn-to-routable seconds; (b) two
   DecodeServer workers on ``ContinuousBatcher(capacity=8)`` at
   ``ENGINE_WIDE`` (seed 0), a ``fleet repo`` process named by ``[fleet]
   repo_addr``, 8 sessions through the stateful router, one worker drained
   mid-stream: every session within ``DECODE_REL`` of the engine alone,
   no error, as many sessions migrated out as in as the worker held; the
   longest handoff; (c) a supervisor with ``Autoscaler(min_workers=1,
   max_workers=2)`` over (a)'s worker arguments, the load generator's
   spike profile scaling it 1 -> 2 -> 1 with nothing lost and the drained
   worker exiting 0; (d) ``TraceCollector`` merging the router's and the
   workers' ``/trace.json`` (one trace id client -> ``nnsq_route`` ->
   ``nnsq_serve`` -> ``device_exec``, clocks aligned within the offset
   estimate's bound), ``collector.fetch_profile`` against a worker under
   load (ROADMAP C17 one process over; its stop's seconds printed), an
   ``invoke_delay`` on one worker giving a ``device`` forensics verdict
   and ``merge_alerts`` the SLO burn, each worker's ``cost_model``
   non-empty.  The kernels launch in the workers: each worker's
   ``stats()`` carries its process's wrapper counts, summed into the
   ``fleet`` path;
32. placement (``partition_phase``): slice 1 at full width (MobileNet-v2
   1.0, 224x224, int8 head) from its launch string, the logits at the sink,
   run in this process under the ``device`` and ``costmodel`` tracers into
   a COST_MODEL.json in a temp dir (the reference labels: the
   image_labeling decoder's argmax); ``plan_partition`` on an unprobed edge
   (all-local: it is never chosen), then a ``PartitionDeployment`` with the
   cut forced at the filter: a ``fragment`` ``FleetWorker`` process on the
   card holding the int8 head (``SubprocFragmentWorker``, warming-gated:
   no traffic before its capture), the normalize on this side;
   ``register_edge`` probes the real NNSQ edge (``probe_edge_health``) and
   the planner runs again on it (plan and scores printed; on one card and
   loopback it may keep everything local, and the cut stays forced); 64
   frames through the split give the in-process labels, logits within
   ``PART_LOGIT_REL``, every frame delivered, ``fused_arith`` once a frame
   in this process and ``int8_matmul`` in the worker's capture only; a
   slow record for the edge flips its regime and ``RepartitionMonitor``
   redeploys exactly once, all-local, through the worker's drain (it
   exits 0); then 64 frames all-local with the same labels;
33. the native queue (``native_queue_phase``): slice 1 from its string on
   the C++ frame queue (``stats()["impl"] == "native"``) and on the Python
   twin (``NNSTPU_COMMON_NATIVE_RUNTIME=off``), labels equal; each leak
   mode behind a consumer that holds frame 0 while 11 more are pushed into
   a queue of 4: ``downstream`` keeps the newest 4 and drops 7,
   ``upstream`` keeps the first 4 and drops 7, ``no`` holds the producer
   and drops none; the EOS pushed into the full queue arrives;
34. the autotune cache (``autotune_phase``): ``autotune_int8_matmul`` at
   (1,1280,1001) and (32,1280,1001): every geometry the kernel launches
   (split-K clusters of 1, 2, 4 and 8 blocks, chunks of 16 rows above 16,
   and the tiled branch) bitwise equal to the plain version, timed (CUDA
   events, 200 launches) and the fastest recorded in a temp cache dir; a
   fresh consult gives the winner and its call is bitwise the plain
   version; with no cache dir the default geometry holds;
35. the soak (``soak_phase``): ``python -m
   nnstreamer_tpu_torch.tools.soak_campaign --lockdep`` on the card, seeds
   from SOAK_BASE_SEED for SOAK_SECONDS: no failed seed (exact on every
   frame) and no lock-order cycle; the lockdep report's counts printed;
36. prints every path number beside the card's name and power limit, one
   JSON line describing every kernel, and last one JSON line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Without a CUDA GPU, or without the package
beside it, the script exits non-zero and prints no result.  Each phase
names itself on standard error as it starts; one still running after
``PHASE_LIMIT_S`` has hung, and the script writes every thread's stack
there and exits non-zero.  Every CUPTI trace holds the port's graph
launches back while its session starts and stops (``obs/launch_gate.py``,
ROADMAP C17).
"""

from __future__ import annotations

import contextlib
import faulthandler
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
# ROADMAP C13, the folded second conversion: int8, an int add that wraps
# the minimum to the maximum, bfloat16, int8 again, a fused multiply-add.
C13_FOLDED = ("typecast:int8,add:-1,typecast:bfloat16,typecast:int8,"
              "mul:-1.9924718141555786,add:271.73095703125")
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
PEAK_OPS_PER_S = {"float32": 67e12, "int8": 1979e12, "bfloat16": 989e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# A phase still running after this long has hung: every thread's stack goes
# to standard error and the script exits non-zero, inside the run's limit.
PHASE_LIMIT_S = 300


def phase(name: str) -> None:
    """Name the phase that starts now on standard error (where a hang shows
    which phase it was) and re-arm the hang dump for it."""
    print(f"chip_smoke: phase {name}", file=sys.stderr, flush=True)
    faulthandler.dump_traceback_later(PHASE_LIMIT_S, exit=True)


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


@contextlib.contextmanager
def cupti_session(label: str):
    """A torch.profiler session with CUPTI's device activity, the
    deep-profiling lane's lock held (one Kineto session a process) and the
    port's graph launches held back while it starts and stops (ROADMAP
    C17: a stop during a launch can hang)."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.obs.launch_gate import switching
    from nnstreamer_tpu_torch.obs.profiler import capture_lock

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with capture_lock(label):
        with switching():
            prof.start()
        try:
            yield prof
        finally:
            with switching():
                prof.stop()


def profile_cuda(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler (CUPTI); return the
    card's summed kernel and copy time in ms and the number of device
    activities, or (None, 0) when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with cupti_session("chip_smoke profile_cuda") as prof:
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
        # a conversion LLVM folds marks no lanes of its own: int8's minimum
        # wrapped to its maximum by an int add stays fused
        ((IMAGE, IMAGE, 3), floats(np.float32), C13_FOLDED, 0),
    ]
    for dtype, option, reset in ((np.float16, C13_CHAIN, 4),
                                 (np.float32, "typecast:int8,typecast:float32,typecast:int16,"
                                              "mul:1.37,add:0.0071", 4),
                                 (np.float32, "typecast:int8,typecast:float32,typecast:uint16,"
                                              "mul:1.37,add:0.0071", 0),
                                 (np.float32, C13_FOLDED, 0)):
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

    torch.cuda.synchronize()
    with cupti_session("chip_smoke trace") as prof:
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


def profile_path(run, res, kernels, attempts=3):
    """Device busy time, idle share and host-issued operations per frame
    from a traced run of PROFILED frames, and the per-frame launch check:
    PROFILED graph launches, each holding one record of each of the path's
    kernels and none of the other kernels.  A trace that misses the mark is
    taken again, ``attempts`` times in all; the last one must then pass
    ``launch_check``, which allows a launch to lack a record only where the
    tracer demonstrably lost that launch's records.  Returns the trace."""
    want = {k: PROFILED if k in kernels else 0 for k in KERNEL_SYMBOLS}
    for attempt in range(attempts):
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
    from torch.profiler import record_function

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
        with cupti_session("chip_smoke device_split") as prof:
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
             traced=False, build=None, slots=LSTM_SLOTS):
    """Run config 4 over ``xs`` ((step, x) pairs); the h of every step, the
    sink's arrival times and last the card's end of the last step, the
    pipeline, and ``during(p)``'s result (it runs after EOS while the filter
    is open), or with ``traced`` the trace of the steps: the x source waits
    until start() (negotiation, capture) returned and the profiler runs.
    ``restore(p)`` runs before start.  ``build`` (default
    :func:`lstm_pipeline`) and ``slots`` give another repo-slot cycle of the
    same shape (config 4c's)."""
    import threading

    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO

    p = (build or lstm_pipeline)(nns, torch, np, xs, model, slots, tracers)
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
    for s in slots:
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
    BATCH_STREAMS (config 5) and at (N, 300, 300, 3) for N on config 2c's
    dynbatch ladder (its buckets 1, 2 and 4)."""
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
    shapes = [(nb, IMAGE, IMAGE, 3) for nb in BATCH_STREAMS]
    shapes += [(nb, SSD_IMAGE, SSD_IMAGE, 3) for nb in ladder(CASCADE_DYN_MAX_BATCH)]
    for shape in shapes:
        x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(dev)
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
        fa_rows[str(shape)] = row
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


def ladder(max_batch):
    """tensor_dynbatch's buckets up to ``max_batch``: the powers of two."""
    out, b = [], 1
    while b <= max_batch:
        out.append(b)
        b <<= 1
    return out


def dyn_checks(np, captures_before, captures_after, report, buckets, pts_out, n_frames,
               max_batch=None):
    """Config 1d (and config 2c's dynbatch form, with its ``max_batch``):
    the whole ladder captured before PLAYING and nothing after, every frame
    out once and in pts order.  Returns the histogram of the buckets that
    occurred."""
    buckets_of = ladder(max_batch or DYN_MAX_BATCH)
    check(captures_before == len(buckets_of),
          f"{captures_before} captures before the first frame, expected {len(buckets_of)}")
    check(captures_after == captures_before,
          f"{captures_after - captures_before} captures while PLAYING")
    check(report is not None and [c["label"] for c in report["compiled"]] ==
          [f"bucket{b}" for b in buckets_of], f"warmup report {report}")
    check(pts_out == sorted(pts_out) and len(pts_out) == n_frames == len(set(pts_out)),
          f"{len(pts_out)} frames out of {n_frames}, in order: {pts_out == sorted(pts_out)}")
    check(all(b in buckets_of for b in buckets), f"buckets {sorted(set(buckets))}")
    return {str(b): buckets.count(b) for b in buckets_of}


def dyn_loss_unmeasured(tr, buckets) -> bool:
    """Whether the trace's first launch lacks a path record while its bucket
    has no other launch in the trace: CUPTI drops the first records of a
    trace's first launch (ROADMAP queue B), and with no fuller launch of
    the bucket to compare, :func:`dyn_launch_check` cannot tell that loss
    from a kernel missing from the graph.  Such a trace is taken again."""
    if not tr["per_launch"] or len(tr["per_launch"]) != len(buckets):
        return False
    rec, _ = tr["per_launch"][0]
    lacks = any(not rec.get(k) for k in ("fused_arith", "int8_matmul"))
    return lacks and buckets.count(buckets[0]) == 1


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


def dyn_desc(max_batch=None):
    """Config 1d's string (and config 2c's dynbatch form, with its
    ``max_batch``)."""
    return ("datasrc name=s ! tensor_dynbatch name=dyn max_batch="
            f"{max_batch or DYN_MAX_BATCH} ! tensor_transform mode=arithmetic option={NORMALIZE} "
            "acceleration=pallas ! tensor_upload name=u ! queue max-size-buffers=16 ! "
            "tensor_filter framework=torch name=f ! tensor_dynunbatch ! tensor_sink name=out")


def run_batch(nns, torch, desc, n, frames, setup=None, traced=False, during=None,
              on_start=None):
    """Config 5 once: ``frames[i]`` into stream i; ``on_start(p)`` runs as
    the start returns.  Returns (pipeline, each stream's outputs as host
    numpy, the last sink's arrival times, the trace or during's result)."""
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
            if on_start is not None:
                on_start(p)
            check(p.wait(600), f"config 5 did not finish: {desc}")
            result = during(p) if during is not None else None
        finally:
            p.stop()
    return p, got, arrivals, result


def batch_phase(torch, np, K, ops, root, card, keep=None):
    """Config 5 at N=4 (float) and N=8 (int8 head), config 1d with every
    bucket captured before PLAYING, and the pool's fence under a held
    upload stream.  ``keep["batch"]`` gets the checkpoint and config 1d's
    model for the lanes phase."""
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
    if keep is not None:
        keep["batch"] = dict(ckpt=ckpt, poly=poly, dyn_frames=dyn_frames)
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
        for attempt in range(3):
            bhist, bbuckets, _, _, _, tr, _ = dyn_run(traced=True, bursty=True)
            if not dyn_loss_unmeasured(tr, bbuckets):
                break
            print(f"  config 1d's coverage trace (attempt {attempt + 1}): its first launch "
                  f"(bucket {bbuckets[0]}, the bucket's only one) holds "
                  f"{tr['per_launch'][0]}", flush=True)
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


# -- config 2c, the detect -> crop -> classify cascade (phase 18) -----------

CASCADE_LABELS = 91
CASCADE_K = 16             # leg_config2c's k
CASCADE_CROP = 96          # leg_config2c's crop_size
CASCADE_FRAMES = 64
CASCADE_CPU_FRAMES = 4     # frames held against the port's CPU run and the eager call
CASCADE_DYN_FRAMES = 32
CASCADE_DYN_MAX_BATCH = 4
# The card against the port's CPU run (``cascade_faults``): both bfloat16,
# the convs summed in another order (ROADMAP C14).  Two anchors whose CPU
# scores lie within ``score`` of each other may swap ranks; a box of the
# same anchor within ``box_atol + box_rtol`` of its value (bfloat16 steps
# are 1/128 relative, and the decode's exp spreads them); a crop's logits
# within ``logit_rel`` of its largest CPU logit, and its top-1 label equal
# where the CPU's top two lie farther apart than ``label_margin`` of it.
CASCADE_CPU_LIMITS = dict(score=1e-3, box_atol=1 / 32, box_rtol=1 / 16, logit_rel=1 / 16,
                          label_margin=1 / 32)
# The dynbatch rows against the batch-1 cascade on the card: the same rules,
# the same limits (cuDNN may pick other conv algorithms at another batch).
CASCADE_BATCH1_LIMITS = dict(CASCADE_CPU_LIMITS)
# The replay against the eager call on the card: bitwise, or within 1e-3
# relative where a conv algorithm was picked differently (as slice 1's).
CASCADE_REPLAY_REL = 1e-3
CROP_FRAMES = 6            # examples/pipelines/crop_cascade.py's size and topology
CROP_SIDE, CROP_K, CROP_W, CROP_H = 64, 2, 16, 16


def cascade_custom():
    return (f"builder=cascade:build_detect_classify,num_labels={CASCADE_LABELS},"
            f"det_size={SSD_IMAGE},k={CASCADE_K},crop_size={CASCADE_CROP},num_classes={CLASSES}")


def cascade_desc(n, ckpt):
    """Config 2c's string (``leg_config2c``'s model, named by its
    checkpoint): the normalize folds into the cascade's filter."""
    return (f"videotestsrc name=src num-buffers={n} width={SSD_IMAGE} height={SSD_IMAGE} "
            "pattern=random seed=11 ! tensor_converter ! "
            f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
            "tensor_upload name=u ! queue max-size-buffers=16 ! "
            f"tensor_filter framework=torch name=f model={ckpt} custom={cascade_custom()} ! "
            "tensor_sink name=out")


def cascade_reference(torch, model, x, priors):
    """The detector's whole ranking of one normalized frame, called eagerly
    on ``x``'s device with ``model``'s detector: every anchor decoded in
    rank order (``decode_topk`` at k = every anchor, rows ``[x, y, w, h,
    class, score]``) and those anchors' scores by class (``rank_anchors``,
    the ranking ``decode_topk`` reads), both as host arrays."""
    from nnstreamer_tpu_torch.models import ssd_mobilenet

    with torch.inference_mode():
        boxes, scores = ssd_mobilenet.apply(model.params["det"], x, dtype=torch.bfloat16)
        n = boxes.shape[-2]
        ranked = ssd_mobilenet.decode_topk(boxes, scores, priors, k=n)
        by_class, _, idx = ssd_mobilenet.rank_anchors(scores, n)
        return ranked.cpu().numpy(), by_class[idx].cpu().numpy()


def cascade_crop_logits(torch, model, x, dets):
    """``model``'s classifier on the crops of ``x`` at the boxes of
    ``dets``, called eagerly on ``x``'s device (float32 logits, host)."""
    from nnstreamer_tpu_torch.models import cascade, mobilenet_v2

    boxes = torch.from_numpy(np.ascontiguousarray(dets[:, :4])).to(x.device)
    with torch.inference_mode():
        crops = cascade.crop_and_resize(x, boxes, CASCADE_CROP)
        return mobilenet_v2.apply(model.params["cls"], crops,
                                  dtype=torch.bfloat16).float().cpu().numpy()


def cascade_replay_check(np, replays, eagers, rel):
    """Each replay's (dets, logits) against the eager call's on the same
    frame: bitwise, or within ``rel`` of the largest output with the same
    classes and the same top-1 label a crop.  Returns (every frame
    bitwise, the largest relative difference)."""
    exact, worst = True, 0.0
    for i, (got, want) in enumerate(zip(replays, eagers)):
        check(len(got) == len(want) == 2, f"frame {i}: {len(got)} outputs")
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"frame {i}: {a.dtype}{a.shape} against {b.dtype}{b.shape}")
            if np.array_equal(a.view(np.uint32), b.view(np.uint32)):
                continue
            exact = False
            d = float(np.abs(a.astype(np.float64) - b).max() / max(np.abs(b).max(), 1e-30))
            worst = max(worst, d)
            check(d <= rel, f"frame {i}: the replay differs from eager by {d} (relative)")
        check(np.array_equal(got[0][:, 4], want[0][:, 4]), f"frame {i}: classes differ")
        check(np.array_equal(got[1].argmax(-1), want[1].argmax(-1)),
              f"frame {i}: a crop's top-1 label differs from eager")
    return exact, worst


def cascade_faults(np, dets, logits, ranked, by_class, ref_logits, limits):
    """One frame of a cascade's output against a reference run of the same
    frame, as a list of faults (empty where it agrees).

    Detector: ``ranked`` and ``by_class`` are the reference's whole ranking
    (:func:`cascade_reference`).  The row at rank r must be the decode of
    an anchor whose reference score lies within ``limits["score"]`` of the
    reference's rank-r score (scores that close may swap ranks): its box
    and score within ``box_atol + box_rtol * |value|`` of that anchor's,
    preferring the reference's rank-r anchor itself; and its class the
    reference's or one whose reference score for that anchor lies within
    ``limits["score"]`` of it.  Classifier: ``ref_logits`` are the
    reference's crops and classifier on the tested boxes (a box a few
    bfloat16 steps off moves a 96x96 crop by pixels, so the two stages are
    held apart): every crop's logits within ``limits["logit_rel"]`` of its
    largest reference logit, and its top-1 label equal unless the
    reference's top two lie within ``limits["label_margin"]`` of it.
    Returns (what was compared and the largest differences, the faults)."""
    faults = []
    swapped = compared = labels = classes_swapped = 0
    box_err = logit_err = 0.0
    ref = ranked.astype(np.float64)
    cols = [0, 1, 2, 3, 5]
    tol = limits["box_atol"] + limits["box_rtol"] * np.abs(ref[:, cols])
    for r, g in enumerate(dets.astype(np.float64)):
        err = np.abs(ref[:, cols] - g[cols])
        near = np.abs(ref[:, 5] - ref[r, 5]) <= limits["score"]
        fits = near & (err <= tol).all(axis=1)
        if not fits.any():
            faults.append(f"rank {r}: row {g} is the decode of no anchor whose reference score "
                          f"lies within {limits['score']} of the rank's {ref[r, 5]} (the "
                          f"reference's row {ref[r]})")
            continue
        a = r if fits[r] else int(np.argmin(np.where(fits, err.max(axis=1), np.inf)))
        swapped += a != r
        compared += a == r
        box_err = max(box_err, float(err[a].max()))
        cg, cw = int(g[4]) - 1, int(ref[a, 4]) - 1  # class 0 is the background
        gap = abs(float(by_class[a][cg]) - float(by_class[a][cw]))
        if gap > limits["score"]:
            faults.append(f"rank {r}: class {cg + 1} against {cw + 1}, reference scores {gap} "
                          "apart")
        classes_swapped += cg != cw
    for i, (g, w) in enumerate(zip(logits, ref_logits)):
        scale = max(float(np.abs(w).max()), 1e-30)
        d = float(np.abs(g.astype(np.float64) - w).max()) / scale
        logit_err = max(logit_err, d)
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > limits["label_margin"] * scale:
            labels += 1
            if int(g.argmax()) != int(w.argmax()):
                faults.append(f"crop {i}: top-1 label {g.argmax()} against {w.argmax()}")
    if logit_err > limits["logit_rel"]:
        faults.append(f"a crop's logits lie {logit_err} of its largest from the reference's "
                      f"(tolerance {limits['logit_rel']})")
    return dict(ranks_swapped=swapped, ranks_compared=compared, classes_swapped=classes_swapped,
                labels_compared=labels, box_abs_err=box_err, logit_rel_err=logit_err), faults


def cascade_check(np, dets, logits, ranked, by_class, ref_logits, limits, what):
    """:func:`cascade_faults`, failing the run on any fault; returns what
    was compared."""
    stats, faults = cascade_faults(np, dets, logits, ranked, by_class, ref_logits, limits)
    check(not faults, f"{what}: {'; '.join(faults[:4])}")
    return stats


def cascade_batch1_check(np, rows, refs, limits):
    """Config 2c's dynbatch rows against the batch-1 cascade of each frame
    on the card: ``rows[i]`` is frame i's (dets, logits) out of the batched
    capture, ``refs[i]`` frame i's batch-1 reference (ranked, by_class)
    and the batch-1 classifier's logits on row i's boxes, cropped from
    frame i and from frame j = i + 1 (the control).  Every row must agree
    with its own frame (:func:`cascade_faults` under ``limits``), and the
    control, row i against frame j's ranking and crops, must be refused
    for every i, or the check could not tell two rows swapped.  Returns
    the sound reading (summed counts, largest differences) and the
    control's (the fewest faults a pair, its smallest logit difference)."""
    n = len(rows)
    check(n > 1 and len(refs) == n, f"{n} rows against {len(refs)} references")
    per, control_faults, control_logit = [], [], []
    for i, ((dets, logits), (ranked, by_class, own, other)) in enumerate(zip(rows, refs)):
        per.append(cascade_check(np, dets, logits, ranked, by_class, own, limits,
                                 f"dynbatch row {i} against its batch-1 cascade"))
        ranked_j, by_class_j = refs[(i + 1) % n][:2]
        c, faults = cascade_faults(np, dets, logits, ranked_j, by_class_j, other, limits)
        control_faults.append(len(faults))
        control_logit.append(c["logit_rel_err"])
    sound = {k: (max if k.endswith("_err") else sum)(r[k] for r in per) for k in per[0]}
    check(min(control_faults) > 0, "control: a row agrees with the next frame's batch-1 "
                                   f"cascade (faults a row: {control_faults}): a swap would pass")
    return sound, dict(min_faults=min(control_faults), min_logit_rel_err=min(control_logit))


def crop_cascade(nns, torch, device, frames_out):
    """``examples/pipelines/crop_cascade.py`` with its stubs as torch models
    on ``device``: videotestsrc 64x64 into a tee, a detector filter giving
    two regions from the frame's content, ``tensor_crop size=16:16 num=2
    sync_mode=slowest``, a classifier filter pooling each crop to 4 int32
    values (the channel sums and their largest).  Both stubs compute in
    int32, exact on any device.  Returns the classifier's outputs a
    frame."""
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

    W = H = CROP_SIDE
    dev = torch.device(device)
    regions = {"base": torch.tensor([[0, 0, CROP_W, CROP_H], [W - CROP_W, H - CROP_H, CROP_W,
                                                             CROP_H]], dtype=torch.int32,
                                    device=dev),
               "shift": torch.tensor([[1, 0, 0, 0], [0, 0, 0, 0]], dtype=torch.int32,
                                     device=dev)}

    def detect(p, img):
        return p["base"] + p["shift"] * (img.to(torch.int32).sum() % 32).to(torch.int32)

    def classify(p, crops):
        del p
        pooled = crops.to(torch.int32).sum(dim=(1, 2))
        return torch.cat([pooled, pooled.amax(dim=-1, keepdim=True)], dim=-1)

    det = TorchModel(apply=detect, params=regions, device=dev, name="crop_cascade_detector",
                     input_spec=TensorsSpec.of(TensorSpec(np.uint8, (H, W, 3))),
                     output_spec=TensorsSpec.of(TensorSpec(np.int32, (CROP_K, 4))))
    cls = TorchModel(apply=classify, device=dev, name="crop_cascade_classifier",
                     input_spec=TensorsSpec.of(TensorSpec(np.uint8, (CROP_K, CROP_H, CROP_W, 3))),
                     output_spec=TensorsSpec.of(TensorSpec(np.int32, (CROP_K, 4))))
    p = nns.Pipeline(name="crop_cascade")
    src = p.add(nns.make("videotestsrc", name="cam", num_buffers=CROP_FRAMES, width=W, height=H))
    conv = p.add(nns.make("tensor_converter", name="conv"))
    tee = p.add(nns.make("tee", name="t"))
    fdet = p.add(nns.make("tensor_filter", name="det", framework="torch", model=det))
    crop = p.add(nns.make("tensor_crop", name="crop", size=f"{CROP_W}:{CROP_H}", num=CROP_K,
                          sync_mode="slowest"))
    fcls = p.add(nns.make("tensor_filter", name="cls", framework="torch", model=cls))
    sink = p.add(nns.make("tensor_sink", name="out"))
    sink.connect("new-data", lambda f: frames_out.append(
        (f.pts, f.tensor(0).cpu().numpy(), f.meta["tensor_crop"]["regions"])))
    p.link_chain(src, conv, tee)
    p.link("t.src_0", "crop.raw")
    p.link("t.src_1", "det.sink")
    p.link(fdet, "crop.info")
    p.link_chain(crop, fcls, sink)
    p.run(timeout=600)
    return p


def element_cascade_check(np, card, cpu):
    """The element cascade on the card against the same run on the CPU:
    every frame, bit for bit, with its pts and region count."""
    check(len(card) == len(cpu) == CROP_FRAMES,
          f"{len(card)} frames on the card, {len(cpu)} on the CPU, of {CROP_FRAMES}")
    for (pg, g, rg), (pw, w, rw) in zip(card, cpu):
        check(pg == pw and rg == rw == CROP_K, f"pts {pg}/{pw}, regions {rg}/{rw}")
        check(g.shape == w.shape == (CROP_K, 4) and np.array_equal(g.view(np.uint32),
                                                                    w.view(np.uint32)),
              f"frame at pts {pg}: the card's crops classify to {g}, the CPU's to {w}")


def cascade_phase(torch, np, K, ops, root, card):
    """Config 2c at full width, its dynbatch form, and the element cascade."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.models import cascade, mobilenet_v2, ssd_mobilenet
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tree = {"det": ssd_mobilenet._init_tree(0, CASCADE_LABELS, 1.0),
            "cls": mobilenet_v2.init_tree(1, CLASSES, 1.0)}
    ckpt = os.path.join(work, "cascade.npz")
    save_state(tree, ckpt)
    kwargs = dict(num_labels=CASCADE_LABELS, det_size=SSD_IMAGE, k=CASCADE_K,
                  crop_size=CASCADE_CROP, num_classes=CLASSES, params=tree)
    state = {}

    def during(p):
        torch.cuda.synchronize()  # nothing on the path reads the outputs back
        state["end"] = time.perf_counter()
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     folded=not any(type(n).__name__ == "TensorTransform"
                                    for n in p.nodes.values()))
        state["model"] = be.model
        state["frames"] = [torch.from_numpy(p["src"]._make_frame(i))
                           for i in range(CASCADE_CPU_FRAMES)]

    run_pipeline(nns, cascade_desc(WARMUP_FRAMES, ckpt), None, WARMUP_FRAMES)
    K.reset_launches()
    got = []
    t0 = time.perf_counter()
    _, arrivals, _ = run_pipeline(nns, cascade_desc(CASCADE_FRAMES, ckpt), None, CASCADE_FRAMES,
                                  during=during, got=got)
    stats, launches = state["stats"], state["launches"]
    print(f"config 2c over {CASCADE_FRAMES} frames: backend {stats}, wrapper launches "
          f"{launches} ({time.perf_counter() - t0:.3f} s)", flush=True)
    check(state["folded"], "config 2c: the normalize did not fold into the cascade's filter")
    batch_capture_check(stats, CASCADE_FRAMES, launches, ("fused_arith",))
    replays = [tuple(t.cpu().numpy() for t in f.tensors) for f in got[:CASCADE_CPU_FRAMES]]
    with torch.inference_mode():  # the model on the plain chain's output, eagerly
        eager = [tuple(o.cpu().numpy() for o in state["model"](K.fused_arith_plain(x.cuda(), ops)))
                 for x in state["frames"]]
    exact, replay_rel = cascade_replay_check(np, replays, eager, CASCADE_REPLAY_REL)
    for f in got:
        check(tuple(f.tensors[0].shape) == (CASCADE_K, 6) and
              tuple(f.tensors[1].shape) == (CASCADE_K, CLASSES) and
              bool(torch.isfinite(f.tensors[0]).all()) and bool(torch.isfinite(f.tensors[1]).all()),
              f"config 2c output {[tuple(t.shape) for t in f.tensors]}, not finite or misshapen")

    cpu_model = cascade.build_detect_classify(**kwargs, device="cpu")
    priors = ssd_mobilenet.generate_priors(SSD_IMAGE)
    per_frame = []
    t1 = time.perf_counter()
    for i, x in enumerate(state["frames"]):
        xn = K.fused_arith(x, ops)  # the plain chain, on the CPU
        ranked, by_class = cascade_reference(torch, cpu_model, xn, priors)
        per_frame.append(cascade_check(np, *replays[i], ranked, by_class,
                                       cascade_crop_logits(torch, cpu_model, xn, replays[i][0]),
                                       CASCADE_CPU_LIMITS,
                                       f"config 2c frame {i} against the port's CPU run"))
    vs_cpu = {k: (max if k.endswith("_err") else sum)(r[k] for r in per_frame)
              for k in per_frame[0]}
    check(vs_cpu["ranks_compared"] > 0 and vs_cpu["labels_compared"] > 0,
          f"config 2c against the CPU compared nothing: {vs_cpu}")
    r = rates(arrivals, np, end=state["end"])
    res = dict(frames=CASCADE_FRAMES, replays=stats["replays"], **r, capture_s=stats["capture_s"],
               warmup_s=stats["warmup_s"], replay_bitwise_eager=exact,
               replay_vs_eager_rel=replay_rel, vs_cpu=vs_cpu,
               cpu_s_per_frame=(time.perf_counter() - t1) / len(per_frame), launches=launches)
    print(f"config 2c: replays {'bitwise equal to' if exact else 'within ' + str(replay_rel)} "
          f"eager on {CASCADE_CPU_FRAMES} frames; against the port's CPU run {vs_cpu}", flush=True)
    tr = profile_path(lambda n: traced_run(nns, cascade_desc(n, ckpt), None, n), res,
                      ("fused_arith",))
    res["device_records_per_launch"] = max(t for _, t in tr["per_launch"])
    report_path("config 2c", res, card)

    # -- the dynbatch form: every bucket captured before PLAYING ---------------
    m = cascade.build_detect_classify(**kwargs, device=DEVICE)
    poly = TorchModel(apply=m.apply, params=m.params, name="cascade_poly", device=DEVICE,
                      input_spec=TensorsSpec.of(TensorSpec(np.float32,
                                                           (None, SSD_IMAGE, SSD_IMAGE, 3))),
                      output_spec=TensorsSpec.of(TensorSpec(np.float32, (None, CASCADE_K, 6)),
                                                 TensorSpec(np.float32,
                                                            (None, CASCADE_K, CLASSES))))
    rng = np.random.default_rng(13)
    dyn_frames = [torch.from_numpy(rng.integers(0, 256, (SSD_IMAGE, SSD_IMAGE, 3), dtype=np.uint8))
                  for _ in range(CASCADE_DYN_FRAMES)]
    batches, out, arrivals = [], [], []
    p = nns.parse_launch(dyn_desc(CASCADE_DYN_MAX_BATCH))
    p["s"].data = [Frame.of(x, pts=i) for i, x in enumerate(dyn_frames)]
    p["f"].model = poly
    dyn, push = p["dyn"], p["dyn"].push

    def recording_push(frame, pad_name=None):
        batches.append((list(frame.meta["dynbatch"]["pts"]), int(frame.tensors[0].shape[0])))
        push(frame, pad_name)

    dyn.push = recording_push
    p["out"].connect("new-data", lambda f: (out.append((f.pts, tuple(t.cpu().numpy()
                                                                      for t in f.tensors))),
                                            arrivals.append(time.perf_counter())))
    os.environ["NNSTPU_COMPILE_WARMUP"] = "1"
    K.reset_launches()
    gate = p["u"]._lock
    gate.acquire()
    try:
        try:
            p.start()
        finally:
            gate.release()
        be = p["f"].backend
        before = be.stats["captures"]
        check(p.wait(600), "config 2c's dynbatch form did not finish")
        dyn_launches = {k.__name__: k.launches for k in K.KERNELS}
        eager = {}
        with torch.inference_mode():  # the model on the plain chain's output, eagerly
            for pts, b in batches:
                x = torch.stack([dyn_frames[i] for i in pts] +
                                [dyn_frames[pts[-1]]] * (b - len(pts))).cuda()
                eager[tuple(pts)] = tuple(o.cpu().numpy()
                                          for o in m(K.fused_arith_plain(x, ops)))
        after, dyn_stats, report = be.stats["captures"], dict(be.stats), p.warmup_report
    finally:
        os.environ.pop("NNSTPU_COMPILE_WARMUP", None)
        p.stop()
    buckets = [b for _, b in batches]
    hist = dyn_checks(np, before, after, report, buckets, [pts for pts, _ in out],
                      CASCADE_DYN_FRAMES, max_batch=CASCADE_DYN_MAX_BATCH)
    check(dyn_launches == {"fused_arith": dyn_stats["warmup_calls"] + dyn_stats["captures"],
                           "int8_matmul": 0, "pallas_nms_keep": 0},
          f"config 2c dynbatch: wrapper launches {dyn_launches}, stats {dyn_stats}")
    by_pts = dict(out)
    rows_got, rows_want = [], []
    for pts, b in batches:
        for j, f in enumerate(pts):
            rows_got.append(by_pts[f])
            rows_want.append(tuple(o[j] for o in eager[tuple(pts)]))
    dyn_exact, dyn_rel = cascade_replay_check(np, rows_got, rows_want, CASCADE_REPLAY_REL)
    # each row against the batch-1 cascade of its own frame, and of the next
    refs = []
    xns = [K.fused_arith_plain(x.cuda(), ops) for x in dyn_frames]
    for i, xn in enumerate(xns):
        dets = by_pts[i][0]
        refs.append(cascade_reference(torch, m, xn, priors) +
                    (cascade_crop_logits(torch, m, xn, dets),
                     cascade_crop_logits(torch, m, xns[(i + 1) % len(xns)], dets)))
    sound, control = cascade_batch1_check(np, [by_pts[i] for i in range(len(xns))], refs,
                                          CASCADE_BATCH1_LIMITS)
    r = rates(arrivals, np)
    dyn_res = dict(frames=CASCADE_DYN_FRAMES, batches=len(batches), buckets=hist, fps=r["fps"],
                   p50_ms=r["p50_ms"], p90_ms=r["p90_ms"], captures_before_playing=before,
                   warmup_s=report["seconds"], rows_bitwise_eager=dyn_exact,
                   rows_vs_eager_rel=dyn_rel, vs_batch1=sound, batch1_control=control,
                   launches=dyn_launches)
    print(f"config 2c dynbatch: {CASCADE_DYN_FRAMES} frames, {before} captures before the first "
          f"frame and none while PLAYING, buckets {hist}, rows "
          f"{'bitwise equal to' if dyn_exact else 'within ' + str(dyn_rel) + ' of'} the eager "
          f"forward of the same rows, {r['fps']} frames/s [{card}]; against each frame's "
          f"batch-1 cascade {sound}, control (row i against frame i + 1) {control}", flush=True)

    # -- the element cascade: tee, detector, tensor_crop, classifier ----------
    on_card, on_cpu = [], []
    K.reset_launches()
    crop_cascade(nns, torch, DEVICE, on_card)
    crop_launches = {k.__name__: k.launches for k in K.KERNELS}
    crop_cascade(nns, torch, "cpu", on_cpu)
    element_cascade_check(np, on_card, on_cpu)
    print(f"crop cascade ({CROP_FRAMES} frames, tensor_crop size={CROP_W}:{CROP_H} "
          f"num={CROP_K}): the card's outputs equal the CPU's bit for bit", flush=True)
    return launches, res, dict(dyn_res, element_cascade=dict(frames=len(on_card),
                                                             launches=crop_launches))


# -- the app surface: PipelineHandle, SingleShot, the C ABI, the CLI (19) --

APP_FRAMES = 32
APP_CLOSED = range(8, 16)  # frames pushed while the valve is closed
APP_SWITCH = 16            # the output-selector sends frames to src_1 from here on
APP_REL = 1e-3             # logits apart by a conv algorithm picked differently
CLI_FRAMES = 8


def app_custom():
    return (f"builder=mobilenet_v2:build_quantized,int8_head=1,image_size={IMAGE},"
            f"num_classes={CLASSES}")


def app_desc(ckpt):
    """The app path: an appsrc, the normalize (on the card), upload and
    queue, a valve, slice 1's int8-head model, an output-selector into two
    sinks."""
    caps = (f"other/tensor, dimension=(string)3:{IMAGE}:{IMAGE}:1, type=(string)uint8, "
            "framerate=(fraction)0/1")
    return (f"appsrc name=in caps='{caps}' ! "
            f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
            "tensor_upload name=u ! queue max-size-buffers=16 ! valve name=v ! "
            f"tensor_filter framework=torch name=f model={ckpt} custom={app_custom()} ! "
            "output-selector name=s s.src_0 ! tensor_sink name=a s.src_1 ! tensor_sink name=b")


def cli_desc(ckpt):
    return (f"videotestsrc num-buffers={CLI_FRAMES} width={IMAGE} height={IMAGE} ! "
            f"tensor_converter ! tensor_transform mode=arithmetic option={NORMALIZE} "
            "acceleration=pallas ! tensor_upload ! queue ! "
            f"tensor_filter framework=torch model={ckpt} custom={app_custom()} ! "
            "tensor_sink name=out")


def app_checks(got_a, got_b, n, closed, switch):
    """The pts each sink received: sink a the frames before the valve
    closed, sink b those from the switch on, none pushed while closed."""
    want_a = [i for i in range(n) if i < closed.start]
    want_b = [i for i in range(switch, n)]
    check(got_a == want_a, f"sink a got pts {got_a}, expected {want_a}")
    check(got_b == want_b, f"sink b got pts {got_b}, expected {want_b}")
    check(not set(closed) & (set(got_a) | set(got_b)), "a frame passed the closed valve")


def logits_check(np, got, want, rel):
    """Two forms' logits, frame by frame: bitwise, or within ``rel`` of the
    largest with the same top-1.  Returns (all bitwise, largest relative)."""
    exact, worst = True, 0.0
    check(len(got) == len(want) > 0, f"{len(got)} outputs against {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype, f"frame {i}: {a.shape}/{b.shape}")
        if np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            continue
        exact = False
        d = float(np.abs(a.astype(np.float64) - b).max() / max(np.abs(b).max(), 1e-30))
        worst = max(worst, d)
        check(d <= rel and int(a.argmax()) == int(b.argmax()),
              f"frame {i}: logits {d} of the largest apart (tolerance {rel}), top-1 "
              f"{a.argmax()} against {b.argmax()}")
    return exact, worst


def cli_check(rc, stdout, stderr, frames):
    """The CLI's run: exit code 0, a report line a frame, the EOS line."""
    check(rc == 0, f"the CLI exited {rc}: {stderr[-2000:]}")
    lines = [ln for ln in stdout.splitlines() if ln.startswith("out: frame ")]
    check(len(lines) == frames and lines[-1].startswith(f"out: frame {frames} ")
          and "float32(1001,)" in lines[-1], f"the CLI's frame reports: {lines}")
    check(f"; {frames} sink frames" in stdout and "EOS after" in stdout,
          f"the CLI's EOS line is missing: {stdout[-500:]}")


def app_phase(torch, np, K, ops, root, card):
    """The app surface on the card: PipelineHandle with appsrc, a valve and
    an output-selector; SingleShot on the same model (direct and with a
    timeout, on its worker thread); the C ABI through ctypes; the CLI."""
    import ctypes

    from nnstreamer_tpu_torch.api import PipelineHandle, SingleShot
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.native import capi
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    ckpt = os.path.join(work, "mobilenet_v2_app.npz")
    save_state(mobilenet_v2.init_tree(0, CLASSES, 1.0), ckpt)
    rng = np.random.default_rng(17)
    frames = [rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8) for _ in range(APP_FRAMES)]

    def wait_until(cond, what):
        deadline = time.monotonic() + 120
        while not cond():
            check(time.monotonic() < deadline, f"app path: timed out waiting for {what}")
            time.sleep(0.002)

    h = PipelineHandle.construct(app_desc(ckpt))
    got = {"a": [], "b": []}
    for name in got:
        h.sink_register(name, lambda f, name=name: got[name].append(
            (f.pts, f.tensor(0).cpu().numpy())))
    valve = h.valves["v"]
    seen = []
    valve_process = valve.process

    def counting(pad, frame):
        seen.append(frame.pts)
        return valve_process(pad, frame)

    valve.process = counting
    K.reset_launches()
    t0 = time.perf_counter()
    with h:
        h.start()
        for i in range(APP_FRAMES):
            if i == APP_CLOSED.start:
                wait_until(lambda: len(got["a"]) == i, f"{i} frames at sink a")
                h.valve_set_open("v", False)
            if i == APP_CLOSED.stop:
                wait_until(lambda: len(seen) == i, f"{i} frames at the valve")
                h.valve_set_open("v", True)
            if i == APP_SWITCH:
                h.switch_select("s", "src_1")
            h.src_input("in", frames[i], pts=i)
        h.src_eos("in")
        check(h.wait(600), "the app path did not finish")
        launches = {k.__name__: k.launches for k in K.KERNELS}
        stats = dict(h.pipeline["f"].backend.stats)
    wall = time.perf_counter() - t0
    app_checks([pts for pts, _ in got["a"]], [pts for pts, _ in got["b"]], APP_FRAMES,
               APP_CLOSED, APP_SWITCH)
    delivered = sorted(got["a"] + got["b"], key=lambda t: t[0])
    check(stats["captures"] == 1 and stats["replays"] == len(delivered),
          f"app path: one capture and {len(delivered)} replays expected: {stats}")
    check(launches == {"fused_arith": APP_FRAMES, "int8_matmul": stats["warmup_calls"] + 1,
                       "pallas_nms_keep": 0},
          f"app path wrapper launches {launches}: the normalize once a frame pushed, the head "
          "in the filter's warm-up calls and capture")
    print(f"app path: {APP_FRAMES} frames pushed through appsrc, {len(APP_CLOSED)} dropped at "
          f"the closed valve, {len(got['a'])} to sink a, {len(got['b'])} to sink b after the "
          f"switch; wrapper launches {launches}; {wall:.3f} s", flush=True)

    # SingleShot on the same model and normalized frames: half directly, half
    # with a timeout (each invoke on the worker thread, on the opening
    # thread's stream)
    xs = [K.fused_arith(torch.from_numpy(frames[pts]).cuda(), ops) for pts, _ in delivered]
    K.reset_launches()
    with SingleShot(framework="torch", model=ckpt, custom=app_custom()) as s:
        half = len(xs) // 2
        single = [s.invoke(x)[0].cpu().numpy() for x in xs[:half]]
        s.set_timeout(120.0)
        single += [s.invoke(x)[0].cpu().numpy() for x in xs[half:]]
        check(s.input_spec().tensors[0].shape == (IMAGE, IMAGE, 3)
              and s.output_spec().tensors[0].shape == (CLASSES,), "SingleShot's specs")
    single_launches = {k.__name__: k.launches for k in K.KERNELS}
    check(single_launches["int8_matmul"] > 0, f"SingleShot's launches {single_launches}")
    single_exact, single_rel = logits_check(np, [lg for _, lg in delivered], single, APP_REL)

    # the C ABI, loaded into this interpreter with ctypes
    t1 = time.perf_counter()
    lib = ctypes.CDLL(capi.build_capi())
    build_s = time.perf_counter() - t1
    lib.ml_tensors_info_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.ml_tensors_data_get_tensor_data.argtypes = [
        ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.ml_tensors_data_set_tensor_data.argtypes = [ctypes.c_void_p, ctypes.c_uint,
                                                    ctypes.c_void_p, ctypes.c_size_t]
    info, single_h = ctypes.c_void_p(), ctypes.c_void_p()
    check(lib.ml_tensors_info_create(ctypes.byref(info)) == 0, "ml_tensors_info_create")
    lib.ml_tensors_info_set_count(info, 1)
    lib.ml_tensors_info_set_tensor_type(info, 0, 7)  # ML_TENSOR_TYPE_FLOAT32
    lib.ml_tensors_info_set_tensor_dimension(info, 0, 3, (ctypes.c_uint32 * 8)(IMAGE, IMAGE, 3))
    K.reset_launches()
    check(lib.ml_single_open(ctypes.byref(single_h), ckpt.encode(), b"torch",
                             app_custom().encode(), info) == 0, "ml_single_open")
    capi_bytes = []
    try:
        for x in xs[:4]:
            data, out = ctypes.c_void_p(), ctypes.c_void_p()
            host = x.cpu().numpy()
            check(lib.ml_tensors_data_create(info, ctypes.byref(data)) == 0, "data_create")
            check(lib.ml_tensors_data_set_tensor_data(data, 0, host.ctypes.data, host.nbytes) == 0,
                  "set_tensor_data")
            check(lib.ml_single_invoke(single_h, data, ctypes.byref(out)) == 0, "ml_single_invoke")
            raw, size = ctypes.c_void_p(), ctypes.c_size_t()
            check(lib.ml_tensors_data_get_tensor_data(out, 0, ctypes.byref(raw),
                                                      ctypes.byref(size)) == 0, "get_tensor_data")
            capi_bytes.append(ctypes.string_at(raw, size.value))
            lib.ml_tensors_data_destroy(data)
            lib.ml_tensors_data_destroy(out)
    finally:
        check(lib.ml_single_close(single_h) == 0, "ml_single_close")
        lib.ml_tensors_info_destroy(info)
    capi_launches = {k.__name__: k.launches for k in K.KERNELS}
    check(capi_launches["int8_matmul"] > 0, f"the C ABI's launches {capi_launches}")
    check(capi_bytes == [lg.tobytes() for lg in single[:4]],
          "the C ABI's output bytes differ from SingleShot's on the same frames")

    # the CLI, as its own process on the card
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([root] + [q for q in env.get("PYTHONPATH", "").split(
        os.pathsep) if q])
    t2 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch", cli_desc(ckpt)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=root)
    cli_s = time.perf_counter() - t2
    cli_check(cli.returncode, cli.stdout, cli.stderr, CLI_FRAMES)
    print(f"app surface: SingleShot's logits {'bitwise equal to' if single_exact else 'within ' + str(single_rel) + ' of'} "
          f"the pipeline's on {len(xs)} frames ({half} direct, {len(xs) - half} on its worker "
          f"thread); the C ABI's output bytes equal SingleShot's on 4 frames (library built in "
          f"{build_s:.3f} s); the CLI exited 0 with {CLI_FRAMES} frame reports in {cli_s:.3f} s "
          f"[{card}]", flush=True)
    res = dict(frames=APP_FRAMES, dropped=len(APP_CLOSED), sink_a=len(got["a"]),
               sink_b=len(got["b"]), wall_s=wall, launches=launches,
               single_bitwise=single_exact, single_rel=single_rel,
               single_launches=single_launches, capi_frames=len(capi_bytes),
               capi_launches=capi_launches, capi_build_s=build_s, cli_s=cli_s)
    return res, {"app_single": single_launches, "app_capi": capi_launches}


# The transformer family (ViT-B/16, config 4c and config 4d).  ViT-B/16 at
# the paper's widths (Dosovitskiy et al. 2020, Table 1), seed-0 weights from
# the port's numpy init, bfloat16; the card's logits are held to the port's
# CPU forward of the same params within VIT_LOGIT_REL of the largest (twelve
# layers of bfloat16 products summed in another order), with the same top-1
# wherever the CPU's top-1 leads its runner-up by more than that.  The decode
# cell is bench.py's DECODE_CELL (configs 4c and 4d share it); float32, TF32
# off, so a stream's outputs are held to the port's CPU forward and to the
# eager loop on the card within DECODE_REL of the largest output.
VIT_B16 = dict(num_classes=1000, patch=16, d_model=768, n_heads=12, n_layers=12)
VIT_Q8_FRAMES = 16
VIT_CPU_FRAMES = 2
VIT_REPLAY_FRAMES = 8
VIT_LOGIT_REL = 1 / 32
DECODE_CELL = dict(t_max=128, d_in=64, n_out=16, d_model=256, n_heads=8, n_layers=2)
DECODE_STEPS = 120      # leg_config4c's clamp: the t_max=128 cache bounds the stream
DECODE_SLOTS = (92, 93)
DECODE_CPU_STEPS = 8
DECODE_REL = 1e-5
ENGINE_CAPACITY = 8     # leg_config4d's capacity
ENGINE_STEPS = 119      # leg_config4d's steps a stream (warm-up step + 119 <= t_max)
STAGGER_STREAMS = 12    # the staggered-join run: stream k joins at step STAGGER_GAP * k,
STAGGER_STEPS = 16      # runs STAGGER_STEPS steps and leaves; all 8 slots fill, and
STAGGER_GAP = 2         # streams 8 to 11 take the slots freed by 0 to 3
PREFILL_PROMPT = 64
PREFILL_TOKENS = 119    # leg_config4d's prefill length (the 128 bucket)
PREFILL_REPS = 16
WINDOW_EXTRA = 8        # ring-window steps past t_max
ENGINE_WIDE = dict(t_max=128, d_in=64, n_out=16, d_model=768, n_heads=12, n_layers=12)
ENGINE_WIDE_STEPS = 64


def vit_checks(stats, launches, frames):
    """The ViT path: one capture, a replay a frame, ``fused_arith`` launched
    only in the capture's warm-up calls and the capture, no other kernel."""
    check(stats["captures"] == 1 and stats["replays"] == frames,
          f"expected one capture and {frames} replays: {stats}")
    check(launches["fused_arith"] == stats["warmup_calls"] + 1,
          f"fused_arith: {launches['fused_arith']} wrapper launches, expected the "
          f"{stats['warmup_calls']} warm-up calls and the capture")
    check(launches["int8_matmul"] == 0 and launches["pallas_nms_keep"] == 0,
          f"a kernel off the ViT path launched: {launches}")


def vit_cpu_check(np, card, cpu, rel):
    """The card's logits against the port's CPU forward of the same params on
    the same frames: within ``rel`` of the largest CPU logit; the same top-1
    where the CPU's top-1 leads its runner-up by more than that, else the
    card's top-1 within that margin of the CPU's largest logit.  Returns the
    largest relative difference and the frames decided by the margin."""
    check(len(card) == len(cpu) > 0, f"{len(card)} card frames against {len(cpu)}")
    worst, close = 0.0, 0
    for i, (a, b) in enumerate(zip(card, cpu)):
        scale = float(np.abs(b).max())
        d = float(np.abs(a.astype(np.float64) - b).max()) / scale
        worst = max(worst, d)
        check(d <= rel, f"frame {i}: card logits {d} of the largest from the CPU's "
                        f"(tolerance {rel})")
        runner, top = np.sort(b)[-2:]
        if top - runner > rel * scale:
            check(int(a.argmax()) == int(b.argmax()),
                  f"frame {i}: top-1 {a.argmax()} on the card, {b.argmax()} on the CPU")
        else:
            close += 1
            check(top - b[int(a.argmax())] <= rel * scale,
                  f"frame {i}: the card's top-1 {a.argmax()} is not within the margin of the "
                  "CPU's largest logit")
    return worst, close


def decode_checks(np, stats, steps, copies, dtoh, got, eager):
    """Config 4c's cycle: the recurrence checks (one capture, a replay a
    step, no device→host copy), and every output finite and bit for bit the
    eager decode loop's on the card."""
    recurrence_checks(stats, steps, copies, dtoh)
    check(len(got) == len(eager) == steps, f"{len(got)} outputs, {len(eager)} eager")
    for i, (a, b) in enumerate(zip(got, eager)):
        check(bool(np.isfinite(a).all()), f"step {i}: output not finite")
        check(a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32)),
              f"step {i}: the cycle's output differs from the eager decode loop")


def staggered_check(np, served, alone, eager, rel):
    """Config 4d's exactness: each stream served among the others that
    joined and left around it equals, bit for bit, the same stream served
    alone in the same slot of the engine (no reduction crosses the slot
    axis), and lies within ``rel`` of the largest output of the eager
    single-stream decode loop.  Returns the largest relative difference."""
    worst = 0.0
    check(served.keys() == alone.keys() == eager.keys() and served,
          f"streams {sorted(served)} / {sorted(alone)} / {sorted(eager)}")
    for k in served:
        check(len(served[k]) == len(alone[k]) == len(eager[k]) > 0,
              f"stream {k}: {len(served[k])} outputs, alone {len(alone[k])}")
        for i, (a, b, e) in enumerate(zip(served[k], alone[k], eager[k])):
            check(np.array_equal(a.view(np.uint32), b.view(np.uint32)),
                  f"stream {k} step {i}: served among others differs from served alone")
            d = float(np.abs(a.astype(np.float64) - e).max()) / float(np.abs(e).max())
            worst = max(worst, d)
            check(d <= rel, f"stream {k} step {i}: {d} of the largest from the eager loop "
                            f"(tolerance {rel})")
    return worst


def vit_desc(n, labels):
    return (f"videotestsrc name=src num-buffers={n} width={IMAGE} height={IMAGE} "
            "pattern=random seed=7 ! tensor_converter name=conv ! "
            f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
            "tensor_upload name=u ! queue max-size-buffers=16 ! "
            "tensor_filter framework=torch name=f ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "tensor_sink name=out collect=true")


def vit_phase(torch, np, K, ops, root, card, keep):
    """ViT-B/16 (bfloat16) handed to the filter of slice 1's launch string,
    64 frames; then its W8A8 form, 16 frames."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.models import vit

    cfg = dict(VIT_B16, image_size=IMAGE)
    tree = vit.init_tree(0, **cfg)
    t0 = time.perf_counter()
    model = vit.build(**cfg, dtype="bfloat16", params=tree, device=DEVICE)
    build_s = time.perf_counter() - t0
    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    labels = os.path.join(work, f"labels_{cfg['num_classes']}.txt")
    with open(labels, "w", encoding="utf-8") as f:
        f.write("\n".join(f"class_{i}" for i in range(cfg["num_classes"])))
    state = {}

    def during(p, replay_frames, cpu_frames):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     transform_folded=not any(type(n).__name__ == "TensorTransform"
                                              for n in p.nodes.values()))
        src = p["src"]
        xs = [torch.from_numpy(src._make_frame(i)) for i in range(replay_frames)]
        captured_against_eager(torch, be, xs, exact=True)
        with torch.inference_mode():
            state["card"] = [be.invoke((x,))[0].float().cpu().numpy() for x in xs[:cpu_frames]]
        state["src"] = src
        return p

    keep["vit"] = (lambda n: vit_desc(n, labels), model)
    run_pipeline(nns, vit_desc(WARMUP_FRAMES, labels), model, WARMUP_FRAMES)
    K.reset_launches()
    p, arrivals, _ = run_pipeline(nns, vit_desc(FRAMES, labels), model, FRAMES,
                                  during=lambda p: during(p, VIT_REPLAY_FRAMES, VIT_CPU_FRAMES))
    stats, launches = state["stats"], state["launches"]
    print(f"ViT-B/16 over {FRAMES} frames: backend {stats}, wrapper launches {launches}",
          flush=True)
    check(state["transform_folded"], "the normalize did not fold across upload and queue")
    vit_checks(stats, launches, FRAMES)
    got = p["out"].frames
    check(all(0 <= f.meta["label_index"] < cfg["num_classes"] for f in got), "labels out of range")
    cpu = vit.build(**cfg, dtype="bfloat16", params=tree, device="cpu")
    t1 = time.perf_counter()
    with torch.inference_mode():
        cpu_logits = [cpu(K.fused_arith_plain(torch.from_numpy(state["src"]._make_frame(i)), ops))
                      .numpy() for i in range(VIT_CPU_FRAMES)]
    cpu_s = time.perf_counter() - t1
    worst, close = vit_cpu_check(np, state["card"], cpu_logits, VIT_LOGIT_REL)
    print(f"ViT-B/16: replays bitwise equal to eager on {VIT_REPLAY_FRAMES} frames; card logits "
          f"within {worst:.3g} of the port's CPU forward on {VIT_CPU_FRAMES} frames (tolerance "
          f"{VIT_LOGIT_REL}, {close} top-1 decided by the margin; CPU forward {cpu_s:.1f} s)",
          flush=True)
    flops = vit.flops_per_frame(cfg["image_size"], cfg["patch"], cfg["d_model"],
                                cfg["n_layers"], cfg["num_classes"])
    res = dict(frames=FRAMES, replays=stats["replays"], **rates(arrivals, np), build_s=build_s,
               capture_s=stats["capture_s"], warmup_s=stats["warmup_s"], cpu_rel_err=worst,
               top1_by_margin=close, flops_per_frame=flops)
    profile_path(lambda n: traced_run(nns, vit_desc(n, labels), model, n), res, ("fused_arith",))
    busy_s = res["device_busy_ms_per_frame"] / 1e3
    res.update(tflops_busy=flops / busy_s / 1e12, tflops_wall=flops * res["fps"] / 1e12,
               busy_share_of_bf16_peak=flops / busy_s / PEAK_OPS_PER_S["bfloat16"])
    report_path("ViT-B/16", res, card)
    for key in ("flops_per_frame", "tflops_busy", "tflops_wall", "busy_share_of_bf16_peak"):
        print(f"  ViT-B/16 {key}: {res[key]} [{card}]", flush=True)

    # The W8A8 form: every trunk matmul int8 on torch._int_mm.
    q8 = vit.build_quantized(**cfg, dtype="bfloat16", params=tree, device=DEVICE)
    state.clear()
    K.reset_launches()
    qp, qarrivals, _ = run_pipeline(nns, vit_desc(VIT_Q8_FRAMES, labels), q8, VIT_Q8_FRAMES,
                                    during=lambda p: during(p, 4, 0))
    vit_checks(state["stats"], state["launches"], VIT_Q8_FRAMES)
    qlaunches = state["launches"]
    qres = dict(frames=VIT_Q8_FRAMES, replays=state["stats"]["replays"], **rates(qarrivals, np),
                capture_s=state["stats"]["capture_s"])
    print(f"ViT-B/16 W8A8 over {VIT_Q8_FRAMES} frames: backend {state['stats']}; replays "
          "bitwise equal to eager on 4 frames", flush=True)
    profile_path(lambda n: traced_run(nns, vit_desc(n, labels), q8, n), qres, ("fused_arith",))
    report_path("ViT-B/16 W8A8", qres, card)
    return (launches, res), (qlaunches, qres)


def decode_pipeline(nns, torch, np, xs, model, slots, tracers=()):
    """Config 4c's graph (bench.py's run_kvdecode_fps): a data source for
    x_t and repo sources for the cache and the position (their bootstrap on
    the card) → ``tensor_mux sync-mode=nosync`` → the decode cell →
    ``tensor_demux`` → y_t to the sink, cache and position to their repo
    sinks."""
    from nnstreamer_tpu_torch.buffer import SECOND, Frame
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.repo import TensorRepoSink, TensorRepoSrc

    cell = DECODE_CELL
    cache = nns.TensorsSpec(tensors=(nns.TensorSpec(
        dtype=np.float32, shape=(cell["n_layers"], 2, cell["t_max"], cell["d_model"])),))
    pos = nns.TensorsSpec(tensors=(nns.TensorSpec(dtype=np.int32, shape=(1,)),))
    dur = SECOND // 30
    p = nns.Pipeline(name="kvdecode")
    p.add(nns.make("datasrc", "x_src", data=[Frame.of(torch.from_numpy(x), pts=i * dur,
                                                      duration=dur) for i, x in xs]),
          TensorRepoSrc(name="kv_src", slot_index=slots[0], caps=cache, device=DEVICE),
          TensorRepoSrc(name="pos_src", slot_index=slots[1], caps=pos, device=DEVICE),
          nns.make("tensor_mux", "mux", sync_mode="nosync"),
          TensorFilter(name="f", framework="torch", model=model),
          nns.make("tensor_demux", "demux"), nns.make("tensor_sink", "out"),
          TensorRepoSink(name="kv_sink", slot_index=slots[0]),
          TensorRepoSink(name="pos_sink", slot_index=slots[1]))
    for i, src in enumerate(("x_src", "kv_src", "pos_src")):
        p.link(src, f"mux.sink_{i}")
    p.link_chain("mux", "f", "demux")
    p.link("demux.src_0", "out")
    p.link("demux.src_1", "kv_sink")
    p.link("demux.src_2", "pos_sink")
    for name in tracers:
        p.attach_tracer(name)
    return p


def decode_phase(torch, np, K, root, card):
    """Config 4c: the decode cell through repo slots 92/93 for 120 steps,
    and a traced run of PROFILED steps."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
    from nnstreamer_tpu_torch.models import transformer

    cell = DECODE_CELL
    tree = transformer.init_tree(0, cell["d_model"], cell["n_heads"], cell["n_layers"],
                                 4 * cell["d_model"], cell["d_in"], cell["n_out"])
    model = transformer.build_decode_cell(**cell, params=tree, device=DEVICE)
    rng = np.random.default_rng(5)
    xs = list(enumerate(rng.standard_normal((DECODE_STEPS, cell["d_in"])).astype(np.float32)))
    shape = (cell["n_layers"], 2, cell["t_max"], cell["d_model"])
    state = {}
    kw = dict(build=decode_pipeline, slots=DECODE_SLOTS)

    def during(p):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS})
        c = torch.zeros(shape, device=DEVICE)
        ps = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        eager = []
        with torch.inference_mode():
            for _, x in xs:
                y, c, ps = be.eager(torch.from_numpy(x), c, ps)
                eager.append(y.cpu().numpy())
        state["eager"] = eager
        return p

    GLOBAL_REPO.reset()
    run_lstm(nns, torch, np, xs[:3], model, **kw)  # CUDA context, cuBLAS handles
    GLOBAL_REPO.reset()
    K.reset_launches()
    ys, arrivals, _, _ = run_lstm(nns, torch, np, xs, model, during=during, **kw)
    stats = state["stats"]
    got = [y.cpu().numpy() for y in ys]
    GLOBAL_REPO.reset()
    _, _, tp, tr = run_lstm(nns, torch, np, xs[:PROFILED], model, tracers=("copies",),
                            traced=True, **kw)
    GLOBAL_REPO.reset()
    copy_count = sum(v["copies"] for v in tp.stats()["tracers"]["copies"]["elements"].values())
    kinds = memcpy_counts(tr["count_by_name"])
    launches = tr["calls"].get("cudaGraphLaunch", 0) + tr["calls"].get("cuGraphLaunch", 0)
    check(launches == PROFILED, f"config 4c: {launches} graph launches for {PROFILED} steps")
    decode_checks(np, stats, DECODE_STEPS, copy_count, kinds["DtoH"], got, state["eager"])
    cpu = transformer.build_decode_cell(**cell, params=tree, device="cpu")
    c, ps, cpu_err = torch.zeros(shape), torch.zeros(1, dtype=torch.int32), 0.0
    with torch.inference_mode():
        for (_, x), g in zip(xs[:DECODE_CPU_STEPS], got):
            y, c, ps = cpu(torch.from_numpy(x), c, ps)
            cpu_err = max(cpu_err, float(np.abs(g - y.numpy()).max() / np.abs(y.numpy()).max()))
    check(cpu_err <= DECODE_REL, f"config 4c: {cpu_err} of the largest output from the CPU "
                                 f"forward (tolerance {DECODE_REL})")
    res = dict(steps=DECODE_STEPS, replays=stats["replays"],
               **rates(arrivals[:-1], np, end=arrivals[-1]), cpu_rel_err=cpu_err,
               capture_s=stats["capture_s"])
    res["steps_per_s"] = res.pop("fps")
    busy = tr["busy_ms"] / PROFILED
    res.update(device_busy_ms_per_step=busy,
               device_idle_share=1 - busy * res["steps_per_s"] / 1e3,
               host_ops_per_step=host_ops(tr["calls"]) / PROFILED,
               copies_per_step={k: v / PROFILED for k, v in kinds.items()},
               copies_tracer=copy_count)
    print(f"config 4c over {DECODE_STEPS} steps: backend {stats}; outputs bitwise equal to the "
          f"eager decode loop, within {cpu_err:.3g} of the CPU forward on {DECODE_CPU_STEPS} "
          f"steps (tolerance {DECODE_REL}); no device-to-host copy", flush=True)
    for key in ("steps_per_s", "p50_ms", "p90_ms", "device_busy_ms_per_step",
                "device_idle_share", "host_ops_per_step", "copies_per_step", "capture_s"):
        print(f"  config 4c {key}: {res[key]} [{card}]", flush=True)
    return (state["launches"], res), tree


def eager_stream(torch, np, cell_model, xs, window=False):
    """The single-stream decode loop, eager on the model's device."""
    from nnstreamer_tpu_torch.models import transformer

    p = cell_model.params
    c = transformer.init_decode_cache(len(p["blocks"]), p["ln_f"]["scale"].shape[-1],
                                      DECODE_CELL["t_max"], device=DEVICE)
    ps = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    out = []
    with torch.inference_mode():
        for x in xs:
            y, c, ps = transformer.decode_step(p, torch.from_numpy(x).to(DEVICE), c, ps,
                                               window=window)
            out.append(y.cpu().numpy())
    return out


def served_alone(eng, slot, xs, prompt=None):
    """One stream through ``eng`` in ``slot``, with no other stream fed
    (the sessions opened before its slot came up stay idle)."""
    idle = []
    s = eng.open_session(timeout=30)
    while s.slot != slot:
        idle.append(s)
        s = eng.open_session(timeout=30)
    out = []
    if prompt is not None:
        s.prefill(prompt)
        out.append(s.get(timeout=60))
    for x in xs:
        s.feed(x)
        out.append(s.get(timeout=60))
    for t in idle + [s]:
        t.close()
    return out


def engine_rate(eng, np, rng, steps):
    """All of ``eng``'s slots streaming: a warm-up step each, then ``steps``
    steps a stream queued up front.  Returns aggregate steps a second,
    ticks and steps served."""
    d_in, cap = eng.d_in, eng.capacity
    sessions = [eng.open_session(timeout=30) for _ in range(cap)]
    warm = rng.standard_normal(d_in).astype(np.float32)
    for s in sessions:
        s.feed(warm)
    for s in sessions:
        s.get(timeout=600)
    feeds = [rng.standard_normal(d_in).astype(np.float32) for _ in range(steps)]
    ticks0, served0 = eng.ticks, eng.steps_total
    t0 = time.perf_counter()
    for x in feeds:
        for s in sessions:
            s.feed(x)
    outs = [[s.get(timeout=600) for _ in range(steps)] for s in sessions]
    dt = time.perf_counter() - t0
    for s in sessions:
        s.close()
    check(all(np.isfinite(o).all() for row in outs for o in row), "engine outputs not finite")
    return cap * steps / dt, eng.ticks - ticks0, eng.steps_total - served0


def serving_phase(torch, np, card, tree, single_steps_per_s):
    """Config 4d: ContinuousBatcher(capacity=8) over config 4c's cell."""
    from nnstreamer_tpu_torch.models import transformer
    from nnstreamer_tpu_torch.serving import ContinuousBatcher

    cell = DECODE_CELL
    cell_model = transformer.build_decode_cell(**cell, params=tree, device=DEVICE)
    rng = np.random.default_rng(6)
    res = {}
    t0 = time.perf_counter()
    eng = ContinuousBatcher(capacity=ENGINE_CAPACITY, params=tree, device=DEVICE, **cell)
    res["construct_s"], res["capture_s"] = time.perf_counter() - t0, eng.capture_s
    report = eng.warmup_prefill()
    res["prefill_buckets"] = [c["label"] for c in report["compiled"]]
    res["prefill_warmup_s"] = report["seconds"]
    with eng:
        # staggered joins: stream k joins STAGGER_GAP steps after k - 1 and
        # leaves after its last step; later streams take the freed slots
        streams = {k: list(rng.standard_normal((STAGGER_STEPS, cell["d_in"])).astype(np.float32))
                   for k in range(STAGGER_STREAMS)}
        sessions, served, slot_of, step = {}, {k: [] for k in streams}, {}, 0
        while any(len(served[k]) < STAGGER_STEPS for k in streams):
            for k in streams:
                if k not in sessions and step >= STAGGER_GAP * k:
                    sessions[k] = eng.open_session(timeout=30)
                    slot_of[k] = sessions[k].slot
            live = [k for k in sessions if len(served[k]) < STAGGER_STEPS]
            for k in live:
                sessions[k].feed(streams[k][len(served[k])])
            for k in live:
                served[k].append(sessions[k].get(timeout=60))
                if len(served[k]) == STAGGER_STEPS:
                    sessions[k].close()
            step += 1
        alone = {k: served_alone(eng, slot_of[k], streams[k]) for k in streams}
        eager = {k: eager_stream(torch, np, cell_model, streams[k]) for k in streams}
        res["stagger_rel_err"] = staggered_check(np, served, alone, eager, DECODE_REL)
        res["stagger_slots"] = slot_of
        check(len(set(slot_of.values())) == ENGINE_CAPACITY,
              f"config 4d: the staggered streams used slots {slot_of}, not all {ENGINE_CAPACITY}")
        print(f"config 4d: {STAGGER_STREAMS} staggered streams of {STAGGER_STEPS} steps (slots "
              f"{slot_of}) bitwise equal to each served alone; within "
              f"{res['stagger_rel_err']:.3g} of the eager decode loop", flush=True)

        # throughput: every slot streaming, steps queued up front
        agg, ticks, steps = engine_rate(eng, np, rng, ENGINE_STEPS)
        check(ticks < steps, f"config 4d: {ticks} ticks for {steps} steps: ticks do not coalesce")
        res.update(aggregate_steps_per_s=agg, ticks=ticks, steps=steps, coalescing=steps / ticks,
                   vs_single_stream=agg / single_steps_per_s)
        tr = trace(lambda: engine_rate(eng, np, rng, 16))
        launches = tr["calls"].get("cudaGraphLaunch", 0) + tr["calls"].get("cuGraphLaunch", 0)
        res.update(traced_graph_launches=launches,
                   device_busy_ms_per_tick=tr["busy_ms"] / max(launches, 1))
        # busy time a tick (traced run) times ticks a second (untraced run)
        res["device_idle_share"] = 1 - res["device_busy_ms_per_tick"] * ticks * agg / steps / 1e3

        # prefill + decode against all-stepwise, and prefill's rate
        xs = list(rng.standard_normal((PREFILL_PROMPT + 8, cell["d_in"])).astype(np.float32))
        stepped = served_alone(eng, 0, xs)
        mixed = served_alone(eng, 0, xs[PREFILL_PROMPT:], prompt=np.stack(xs[:PREFILL_PROMPT]))
        pre_err = 0.0
        for a, b in zip(mixed, stepped[PREFILL_PROMPT - 1:]):
            pre_err = max(pre_err, float(np.abs(a - b).max() / np.abs(b).max()))
        check(pre_err <= DECODE_REL, f"config 4d: prefill + decode {pre_err} of the largest "
                                     f"from all-stepwise (tolerance {DECODE_REL})")
        prompt = rng.standard_normal((PREFILL_TOKENS, cell["d_in"])).astype(np.float32)
        s = eng.open_session(timeout=30)
        s.prefill(prompt)
        s.get(timeout=60)
        t1 = time.perf_counter()
        for _ in range(PREFILL_REPS):
            s.prefill(prompt)
            s.get(timeout=60)
        res["prefill_tokens_per_s"] = PREFILL_TOKENS * PREFILL_REPS / (time.perf_counter() - t1)
        s.close()
        res.update(prefill_rel_err=pre_err, stats=eng.stats())

    # the ring: one stream past t_max
    n = cell["t_max"] + WINDOW_EXTRA
    ring_xs = list(rng.standard_normal((n, cell["d_in"])).astype(np.float32))
    with ContinuousBatcher(capacity=2, window=True, params=tree, device=DEVICE, **cell) as ring:
        got = served_alone(ring, 0, ring_xs)
    want = eager_stream(torch, np, cell_model, ring_xs, window=True)
    check(all(np.isfinite(g).all() for g in got), "config 4d: the ring's outputs not finite")
    ring_err = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, want))
    check(ring_err <= DECODE_REL, f"config 4d: the ring {ring_err} of the largest from the eager "
                                  f"loop (tolerance {DECODE_REL})")
    res["ring_rel_err"], res["ring_steps"] = ring_err, n

    # timing only: the engine at ViT-B's trunk width
    wide = ENGINE_WIDE
    wtree = transformer.init_tree(0, wide["d_model"], wide["n_heads"], wide["n_layers"],
                                  4 * wide["d_model"], wide["d_in"], wide["n_out"])
    with ContinuousBatcher(capacity=ENGINE_CAPACITY, params=wtree, device=DEVICE, **wide) as weng:
        cache_mb = weng._caches.numel() * weng._caches.element_size() / 1e6
        wagg, wticks, wsteps = engine_rate(weng, np, rng, ENGINE_WIDE_STEPS)
    res.update(wide_aggregate_steps_per_s=wagg, wide_ticks=wticks, wide_cache_mb=cache_mb,
               wide_ms_per_tick=ENGINE_CAPACITY / wagg * 1e3)
    print(f"config 4d: prefill + decode within {pre_err:.3g} of all-stepwise; the ring past "
          f"t_max ({n} steps) within {ring_err:.3g} of the eager loop", flush=True)
    for key in ("aggregate_steps_per_s", "ticks", "coalescing", "vs_single_stream",
                "device_busy_ms_per_tick", "device_idle_share", "prefill_tokens_per_s",
                "capture_s", "prefill_warmup_s", "wide_aggregate_steps_per_s", "wide_ms_per_tick",
                "wide_cache_mb"):
        print(f"  config 4d {key}: {res[key]} [{card}]", flush=True)
    return res


RECOVERY_FRAMES = 64
RESTART_EVERY = 16      # invoke_raise@f:every=16: frames 16, 32, 48 and 64 fault
QUARANTINE_AFTER = 8    # invoke_raise@f:after=8: one fault, at the ninth frame
POOL_SLACK = 64 << 20   # device bytes in use after the restarts, over the first capture's
WEDGE_FRAMES = 12       # the recover_queue run: every frame waits behind the wedge
LIVE_RATE = 200         # the restart_source run's live source, frames a second
LANE_WINDOW_S = "1"     # [obs] busy_window_s of the device-lane runs
EVENT_SLACK_MS = 1e-3   # the event timer's resolution (0.5 us) and the host clock's


def device_memory():
    """The device lane's allocator snapshot (``{"cuda:0": {...}}``)."""
    from nnstreamer_tpu_torch.obs.device import device_memory_snapshot

    return device_memory_snapshot()


def recovery_desc(n, labels, live=False, queue=16):
    """Slice 1's launch string with its queue named ``q`` holding ``queue``
    frames (``live``: a source at LIVE_RATE frames a second)."""
    pace = f"is-live=true framerate={LIVE_RATE}/1 " if live else ""
    return (f"videotestsrc name=src num-buffers={n} width={IMAGE} height={IMAGE} "
            f"pattern=random seed=7 {pace}! tensor_converter name=conv ! "
            f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
            f"tensor_upload name=u ! queue name=q max-size-buffers={queue} ! "
            "tensor_filter framework=torch name=f ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "tensor_sink name=out collect=true")


def faulted_run(nns, faults, hooks, desc, model, spec, policy, expect_error=False, setup=None,
                during=None):
    """One run of ``desc`` under the fault ``spec`` with ``policy`` on the
    filter ``f``.  Logs every filter output (pts, tensor) through
    ``device_dispatch``, and each restart's wall time from its fault to its
    ``recovery`` record.  ``setup(p)`` runs after the parse, ``during(p)``
    after EOS while the pipeline still plays.  Returns (pipeline, outputs,
    restart seconds, the device bytes in use after the first capture, the
    error raised)."""
    outs, walls, fault_t, first_capture = [], [], [], []

    def on_dispatch(node, frame, o, t0):
        outs.append((frame.pts, o[0]))

    def on_fault(point, kind, target):
        fault_t.append(time.perf_counter())

    def on_recovery(pipeline, action, target, result):
        if action == "restart_node" and fault_t:
            walls.append(time.perf_counter() - fault_t[-1])

    def on_compile(backend, key, result, dur, info):
        if result == "miss" and not first_capture:
            first_capture.append(device_memory()["cuda:0"]["bytes_in_use"])

    p = nns.parse_launch(desc)
    p["f"].model = model
    if policy is not None:
        p.set_restart_policy("f", **policy)
    if setup is not None:
        setup(p)
    eng = faults.install(spec) if spec else None
    hooked = (("device_dispatch", on_dispatch), ("fault", on_fault),
              ("recovery", on_recovery), ("compile", on_compile))
    for name, fn in hooked:
        hooks.connect(name, fn)
    error = None
    try:
        try:
            p.start()
            check(p.wait(600), f"the pipeline did not finish within 600 s: {desc}")
            if during is not None:
                during(p)
        except Exception as exc:  # noqa: BLE001 - the caller checks what was raised
            if not expect_error:
                raise
            error = exc
        mem = device_memory()["cuda:0"]["bytes_in_use"] if not expect_error else None
    finally:
        p.stop()
        for name, fn in hooked:
            hooks.disconnect(name, fn)
        faults.deactivate()
    return p, outs, walls, (first_capture[0] if first_capture else None, mem), eng, error


def recovery_phase(torch, np, K, root, card, keep):
    """Self-healing on slice 1 at full width: restarts under injected
    invoke faults (labels and logits against the fault-free run, 5 captures,
    no graph pool leaked), quarantine, compile faults under fail-pipeline and
    restart, and restart_source and recover_queue on running pipelines."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch import faults
    from nnstreamer_tpu_torch.obs import hooks

    _, model, _, _ = keep["image_labeling"]
    labels = os.path.join(root, "build", "chip_smoke", "labels_1001.txt")
    desc = recovery_desc(RECOVERY_FRAMES, labels)
    restart = dict(mode="restart", backoff_ms=1, backoff_cap_ms=5, max_restarts=8)
    res = {}

    # (a) the fault-free run, then restart under invoke_raise@f:every=16
    p0, clean, _, _, _, _ = faulted_run(nns, faults, hooks, desc, model, None, None)
    want = {pts: o for pts, o in clean}
    want_labels = {f.pts: f.meta["label_index"] for f in p0["out"].frames}
    check(len(want) == RECOVERY_FRAMES, f"the fault-free run gave {len(want)} outputs")
    K.reset_launches()
    p, outs, walls, (mem_first, mem_after), eng, _ = faulted_run(
        nns, faults, hooks, desc, model, f"invoke_raise@f:every={RESTART_EVERY}", restart)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    got = p["out"].frames
    rec, stats = p.recovery_stats(), dict(p["f"].backend.stats)
    faults_n = RECOVERY_FRAMES // RESTART_EVERY
    print(f"recovery (a) restart: {len(got)} of {RECOVERY_FRAMES} frames delivered, "
          f"{rec}, backend {stats}, wrapper launches {launches} [{card}]", flush=True)
    check(eng.injections == {"invoke_raise": faults_n}, f"injections {eng.injections}")
    check(len(got) == RECOVERY_FRAMES - faults_n, f"{len(got)} frames delivered")
    check(rec.get("actions") == {"restart_node": faults_n} and rec.get("shed_total") == faults_n,
          f"recovery ledger {rec}")
    check(stats["captures"] == faults_n + 1, f"{stats['captures']} captures, expected "
                                             f"{faults_n + 1}")
    for name in ("fused_arith", "int8_matmul"):
        check(launches[name] == (faults_n + 1) * (stats["warmup_calls"] // stats["captures"] + 1),
              f"{name}: {launches[name]} launches over {stats['captures']} captures")
    check([f.meta["label_index"] for f in got] == [want_labels[f.pts] for f in got],
          "a label differs from the fault-free run's frame")
    check(len(outs) == len(got), f"{len(outs)} filter outputs for {len(got)} frames")
    worst = 0.0
    for pts, o in outs:
        w = want[pts]
        if not bitwise_equal(torch, o, w):
            worst = max(worst, float((o.double() - w.double()).abs().max()
                                     / w.double().abs().max()))
    check(worst <= 1e-3, f"logits differ from the fault-free run's by {worst} (relative)")
    growth = mem_after - mem_first
    print(f"recovery (a): logits {'bitwise equal to' if worst == 0.0 else 'within '}"
          f"{'' if worst == 0.0 else f'{worst:.3g} of'} the fault-free run's on "
          f"{len(outs)} frames; restart wall s {[round(w, 4) for w in walls]}; device bytes "
          f"in use {mem_first} after the first capture, {mem_after} after the run "
          f"({growth:+d}) [{card}]", flush=True)
    check(len(walls) == faults_n, f"{len(walls)} restart walls")
    check(growth <= POOL_SLACK, f"device bytes in use grew by {growth} over {faults_n} "
                                "restarts: a graph pool leaked")
    res.update(delivered=len(got), recovery=rec, captures=stats["captures"],
               restart_wall_s=walls, logits_rel_err=worst, bytes_in_use_first_capture=mem_first,
               bytes_in_use_after=mem_after, launches=launches)

    # (b) quarantine-passthrough: f's in and out specs differ, so every
    # frame after the fault is shed
    p, _, _, _, eng, _ = faulted_run(nns, faults, hooks, desc, model,
                                     f"invoke_raise@f:after={QUARANTINE_AFTER}",
                                     dict(mode="quarantine-passthrough"))
    rec = p.recovery_stats()
    n_out = len(p["out"].frames)
    print(f"recovery (b) quarantine: {n_out} delivered, {rec} [{card}]", flush=True)
    check(n_out == QUARANTINE_AFTER and rec.get("quarantined") == ["f"],
          f"quarantine delivered {n_out}: {rec}")
    check(n_out + rec["shed_total"] == RECOVERY_FRAMES, "delivered + shed != offered")
    res["quarantine"] = dict(delivered=n_out, recovery=rec)

    # (c) compile_raise:count=1 under fail-pipeline, then under restart
    p, _, _, _, _, error = faulted_run(nns, faults, hooks, desc, model, "compile_raise:count=1",
                                       None, expect_error=True)
    check(isinstance(error, faults.InjectedFault), f"fail-pipeline raised {error!r}")
    t0 = time.perf_counter()
    p, outs, _, _, eng, _ = faulted_run(nns, faults, hooks, desc, model, "compile_raise:count=1",
                                        restart)
    wall = time.perf_counter() - t0
    stats, rec = dict(p["f"].backend.stats), p.recovery_stats()
    on_card = sum(o.is_cuda for _, o in outs)
    print(f"recovery (c) compile_raise: fail-pipeline raised {type(error).__name__}; restart "
          f"delivered {len(p['out'].frames)}, {on_card} outputs on the card, backend {stats}, "
          f"{rec}, run wall {wall:.3f} s [{card}]", flush=True)
    check(len(p["out"].frames) == RECOVERY_FRAMES and on_card == RECOVERY_FRAMES,
          "a frame was not served from the card after the compile fault")
    check(stats["captures"] == 1 and stats["replays"] == RECOVERY_FRAMES, f"backend {stats}")
    check(rec == {"actions": {"restart_node": 1}}, f"recovery ledger {rec}")
    res["compile_raise"] = dict(fail_pipeline=type(error).__name__, recovery=rec,
                                on_card=on_card, captures=stats["captures"])

    # (d) recover_queue: every frame and the EOS wait behind a wedged queue
    faults.install("queue_wedge@q:count=1,ms=1500")
    p = nns.parse_launch(recovery_desc(WEDGE_FRAMES, labels))
    p["f"].model = model
    q = p["q"]
    try:
        p.start()
        deadline = time.monotonic() + 30
        while len(q._q) < WEDGE_FRAMES + 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        depth = len(q._q)
        drained = p.recover_queue("q")
        left = len(q._q)
        check(p.wait(600), "the run did not end after recover_queue")
    finally:
        p.stop()
        faults.deactivate()
    rec = p.recovery_stats()
    print(f"recovery (d) recover_queue: depth {depth}, drained {drained}, dropped {q.dropped}, "
          f"{left} left (the EOS), {len(p['out'].frames)} delivered, {rec} [{card}]", flush=True)
    check(depth == WEDGE_FRAMES + 1 and drained == q.dropped == WEDGE_FRAMES and left == 1,
          "recover_queue did not drain the frames and keep the EOS")
    check(len(p["out"].frames) + rec["shed_total"] == WEDGE_FRAMES, "delivered + shed != offered")

    # (d) restart_source on a live slice after its first frames
    p = nns.parse_launch(recovery_desc(RECOVERY_FRAMES, labels, live=True))
    p["f"].model = model
    try:
        p.start()
        deadline = time.monotonic() + 30
        while len(p["out"].frames) < 8 and time.monotonic() < deadline:
            time.sleep(0.001)
        t0 = time.perf_counter()
        check(p.restart_source("src"), "restart_source refused")
        restart_s = time.perf_counter() - t0
        check(p.wait(600), "the run did not end after restart_source")
    finally:
        p.stop()
    pts = [f.pts for f in p["out"].frames]
    dur = 10**9 // LIVE_RATE  # a frame's pts step
    first = [t // dur for t in pts[:-RECOVERY_FRAMES]]
    print(f"recovery (d) restart_source: {len(first)} frames of the first stream, then "
          f"{len(pts) - len(first)}; {p.recovery_stats()}, restart {restart_s:.4f} s [{card}]",
          flush=True)
    check(first == list(range(len(first))) and len(first) >= 8, f"first stream {first}")
    check([t // dur for t in pts[-RECOVERY_FRAMES:]] == list(range(RECOVERY_FRAMES)),
          "the restarted stream is not frames 0 to 63 in order")
    check(p.recovery_stats() == {"actions": {"restart_source": 1}}, "restart_source ledger")
    res["recover_queue"] = dict(drained=drained, dropped=q.dropped, depth=depth)
    res["restart_source"] = dict(first_stream=len(first), restart_s=restart_s)
    return launches, res


def gauge_value(REGISTRY, name, **labels):
    """The value of a gauge's child with these labels (None if absent)."""
    metric = REGISTRY.get(name)
    if metric is None:
        return None
    for values, child in metric.children():
        if dict(zip(metric.labelnames, values)) == labels:
            return child.value
    return None


def compile_counts(REGISTRY):
    metric = REGISTRY.get("nnstpu_compile_total")
    return {} if metric is None else {v[0]: c.value for v, c in metric.children()}


def lane_run(nns, desc, model, n, traced):
    """One run of ``desc`` (``n`` frames) with the ``device`` tracer
    attached; ``traced``: under CUPTI, the upload's lock holding the source
    until the start has returned.  Returns the readings."""
    from nnstreamer_tpu_torch.obs import spans, util
    from nnstreamer_tpu_torch.obs.device import DeviceTracer
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY

    spans.clear()
    p = nns.parse_launch(desc)
    p["f"].model = model
    tracer = p.attach_tracer(DeviceTracer())
    before = compile_counts(REGISTRY)
    gate = p["u"]._lock
    if traced:
        gate.acquire()
    try:
        p.start()
    except BaseException:
        if traced:
            gate.release()
        raise
    try:
        if traced:
            tr = trace(lambda: (time.sleep(0.25), gate.release(),
                                check(p.wait(600), "traced run did not finish")))
        else:
            tr = None
            check(p.wait(600), "the device-lane run did not finish")
        deadline = time.monotonic() + 30
        while tracer.summary()["completed"] < n and time.monotonic() < deadline:
            time.sleep(0.002)
        REGISTRY.collect()
        out = dict(busy_playing=gauge_value(REGISTRY, "nnstpu_device_busy_fraction",
                                            device="cuda:0"),
                   stats=dict(p["f"].backend.stats), cost=util.cost_of(p["f"].backend.cost_key()),
                   memory=device_memory(), trace=tr)
        out["mfu"] = next((c.value for v, c in REGISTRY.get("nnstpu_mfu").children()
                           if v[1] == "f"), None)
    finally:
        p.stop()
    out["summary"] = tracer.summary()
    out["compiles"] = {k: v - before.get(k, 0) for k, v in compile_counts(REGISTRY).items()
                       if v - before.get(k, 0)}
    out["spans"] = [r for r in spans.snapshot() if r[4] == "device_exec"]
    out["delivered"] = len(p["out"].frames)
    out["tracer"] = tracer
    return out


def lane_checks(r, n, name):
    """One device_exec span a dispatch, reaped == dispatched, no probe
    dropped, each span's event-pair time within its enqueue→done time, the
    compile counters equal to the backend's stats."""
    s, stats = r["summary"], r["stats"]
    check(r["delivered"] == n, f"{name}: {r['delivered']} of {n} frames delivered")
    check(s["dispatches"] == s["completed"] == n and s["dropped"] == 0,
          f"{name}: {s['dispatches']} dispatched, {s['completed']} reaped, {s['dropped']} dropped")
    check(len(r["spans"]) == n, f"{name}: {len(r['spans'])} device_exec spans for {n} frames")
    for rec in r["spans"]:
        args = rec[9]
        check(args["device"] == "cuda:0" and "device_ms" in args, f"{name}: span args {args}")
        check(args["device_ms"] <= rec[2] / 1e6 + EVENT_SLACK_MS,
              f"{name}: event pair {args['device_ms']} ms over enqueue→done {rec[2] / 1e6} ms")
    want = {"miss": stats["captures"], "hit": stats["hits"], "evict": stats["evictions"]}
    check({k: v for k, v in want.items() if v} == r["compiles"],
          f"{name}: nnstpu_compile_total moved by {r['compiles']}, backend {stats}")
    check(s["compiles"]["miss"] == stats["captures"] and s["compiles"]["hit"] == stats["hits"],
          f"{name}: the tracer's compiles {s['compiles']}, backend {stats}")
    return sum(rec[9]["device_ms"] for rec in r["spans"]) / n


def device_lane_phase(torch, np, K, root, card, keep, busy_share):
    """The ``device`` tracer on slice 1 and on ViT-B/16, 64 frames each and
    a traced run of PROFILED frames: spans, event-pair device time against
    CUPTI's busy time, the cost registry's FLOPs, MFU, capture counters,
    memory, the busy fraction and its decay; then the wire probe."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.models import vit
    from nnstreamer_tpu_torch.obs import util
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY

    os.environ["NNSTPU_OBS_BUSY_WINDOW_S"] = LANE_WINDOW_S
    res = {}
    try:
        K.reset_launches()
        for name in ("image_labeling", "vit"):
            desc, model = keep[name][0], keep[name][1]
            full = lane_run(nns, desc(FRAMES), model, FRAMES, traced=False)
            event_ms = lane_checks(full, FRAMES, name)
            traced = lane_run(nns, desc(PROFILED), model, PROFILED, traced=True)
            traced_event_ms = lane_checks(traced, PROFILED, name)
            busy_ms = traced["trace"]["busy_ms"] / PROFILED
            mem = full["memory"]["cuda:0"]
            r = dict(event_ms_per_frame=event_ms, traced_event_ms_per_frame=traced_event_ms,
                     cupti_busy_ms_per_frame=busy_ms, busy_fraction_playing=full["busy_playing"],
                     mfu=full["mfu"], cost=full["cost"], memory=mem,
                     compiles=full["compiles"], enqueue_to_done_ms_per_frame=(
                         full["summary"]["device_ns"] / FRAMES / 1e6))
            print(f"device lane, {name}: event pair {event_ms:.4f} ms a frame ({FRAMES} frames), "
                  f"{traced_event_ms:.4f} ms in the traced run against CUPTI busy "
                  f"{busy_ms:.4f} ms; enqueue→done {r['enqueue_to_done_ms_per_frame']:.4f} ms; "
                  f"busy fraction while playing {full['busy_playing']}; nnstpu_mfu {full['mfu']}; "
                  f"cost {full['cost']}; compiles {full['compiles']}; memory {mem} [{card}]",
                  flush=True)
            check(traced_event_ms >= 0.9 * busy_ms, f"{name}: event pair {traced_event_ms} ms "
                                                    f"under 0.9 x CUPTI busy {busy_ms} ms")
            check(full["busy_playing"] is not None and 0.0 < full["busy_playing"] <= 1.0,
                  f"{name}: busy fraction while playing {full['busy_playing']}")
            check(mem["peak_bytes_in_use"] >= mem["bytes_in_use"] > 0, f"{name}: memory {mem}")
            gauge = full["tracer"]._busy_gauge
            deadline = time.monotonic() + 3 * float(LANE_WINDOW_S)
            while time.monotonic() < deadline:
                REGISTRY.collect()
                if all(c.value == 0.0 for _, c in gauge.children()):
                    break
                time.sleep(0.05)
            check(all(c.value == 0.0 for _, c in gauge.children()),
                  f"{name}: the busy fraction did not decay to 0 after stop()")
            res[name] = r
        cfg = dict(VIT_B16, image_size=IMAGE)
        flops = vit.flops_per_frame(cfg["image_size"], cfg["patch"], cfg["d_model"],
                                    cfg["n_layers"], cfg["num_classes"])
        v = res["vit"]
        got = v["cost"]["flops"]
        check(abs(got - flops) <= 0.02 * flops, f"ViT: the registry's {got} FLOPs against "
                                               f"{flops} from the shapes")
        from nnstreamer_tpu_torch.backends.torch_backend import _nbytes

        params = _nbytes(keep["vit"][1].params)
        check(v["memory"]["bytes_in_use"] >= params, f"ViT: {v['memory']} under its {params} "
                                                     "parameter bytes")
        share = flops / (v["cupti_busy_ms_per_frame"] / 1e3) / util.peak_tflops() / 1e12
        check(v["mfu"] is not None and v["mfu"] <= 1.1 * share,
              f"ViT: nnstpu_mfu {v['mfu']} above 1.1 x the busy-time share {share}")
        v.update(flops_from_shapes=flops, busy_share_of_peak=share, parameter_bytes=params,
                 peak_tflops=util.peak_tflops(), peak_gbs=util.peak_gbs())
        print(f"device lane, ViT-B/16: registry FLOPs {got} against {flops} from the shapes "
              f"({(got - flops) / flops:+.5f}); nnstpu_mfu {v['mfu']} against the CUPTI "
              f"busy-time share {share} (the ViT phase's trace: {busy_share}); peaks "
              f"{v['peak_tflops']} TFLOP/s, {v['peak_gbs']} GB/s [{card}]", flush=True)
        wire = util.publish_wire_health(util.probe_wire_health())
        print(f"device lane: wire probe {wire} [{card}]", flush=True)
        res["wire"] = wire
        launches = {k.__name__: k.launches for k in K.KERNELS}
    finally:
        os.environ.pop("NNSTPU_OBS_BUSY_WINDOW_S", None)
    for r in res.values():
        r.pop("tracer", None)
    return launches, res


# -- the dispatcher lanes and the watchdog (phase 25) -------------------------

LANE_MODES = ("0", "1", "auto")     # config 5's modes: threads, one lane, min(4, cpus)
LANE_SLICE_MODES = ("1", "auto")    # slice 1's lane modes, against its thread mode
LANE_RESTART_MODE = "2"             # the recovery phase's case (a) under two lanes
LANE_SAMPLE_S = 0.001               # the ready-ring sampler's period
WD_INTERVAL_S = 0.05                # the watchdog's tick in the phase
WD_STALL_S = 0.3                    # its stall window
WD_WEDGE_MS = 1500                  # queue_wedge@q's sleep ...
WD_WEDGE_AFTER = 8                  # ... at the consumer's ninth pop
WD_WEDGE_QUEUE = 80                 # the wedged queue's size: the source never blocks on it
WD_STALL_AFTER = 8                  # the stalling source's frames before it blocks
WD_DEADLINE_S = 0.5                 # the device deadline of the overdue-device run
WD_SLEEP_S = 1.5                    # the _sleep filter's device time a frame


class dispatch_lanes:
    """``[dispatch] lanes`` for the runs inside the ``with`` block."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.prev = os.environ.get("NNSTPU_DISPATCH_LANES")
        os.environ["NNSTPU_DISPATCH_LANES"] = self.mode
        return self

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("NNSTPU_DISPATCH_LANES", None)
        else:
            os.environ["NNSTPU_DISPATCH_LANES"] = self.prev


class RingSampler:
    """Samples a pipeline's lane runtime every LANE_SAMPLE_S while it runs:
    the longest stretch in which a lane sat parked while a ready ring held a
    task (stealing, or the wakeup of an arm, ends such a stretch within a
    poll), and the largest ring depth seen."""

    def __init__(self, pipeline):
        import threading

        self.p, self.samples, self.parked_with_work = pipeline, 0, 0
        self.longest_s, self.max_ready = 0.0, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="ring-sampler", daemon=True)
        self._thread.start()

    def _run(self):
        since = None
        while not self._stop.wait(LANE_SAMPLE_S):
            rt = self.p._lanes
            if rt is None:
                since = None
                continue
            ready = [len(r) for r in rt._rings]
            self.samples += 1
            self.max_ready = max(self.max_ready, max(ready))
            now = time.perf_counter()
            if rt._idle > 0 and sum(ready) > 0:
                self.parked_with_work += 1
                since = now if since is None else since
                self.longest_s = max(self.longest_s, now - since)
            else:
                since = None

    def stop(self):
        self._stop.set()
        self._thread.join()
        return dict(samples=self.samples, parked_with_work=self.parked_with_work,
                    longest_parked_with_work_s=self.longest_s, max_ready=self.max_ready)


def counter_sum(REGISTRY, name, **labels):
    """The sum of a metric's children whose labels include these."""
    metric = REGISTRY.get(name)
    if metric is None:
        return 0.0
    return sum(c.value for v, c in metric.children()
               if all(dict(zip(metric.labelnames, v)).get(k) == w for k, w in labels.items()))


def take_launches(K, total, counts=None):
    """Add ``counts`` (by default the wrappers' counts now) to ``total``
    and set the wrappers' counts to 0.  A run that holds its outputs
    against eager forwards passes the counts it read before them: those
    launches compare, they are not the path's."""
    if counts is None:
        counts = {k.__name__: k.launches for k in K.KERNELS}
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    K.reset_launches()


def rounds_matched(np, runs, rounds):
    """Config 5 in each lane mode against thread mode (``runs["0"]``):
    wherever both hold round r of every stream (stream_check holds each
    mode's round r to the eager forward of the same frames), its rows must
    be equal bit for bit.  Returns the rounds that matched in each mode."""
    base = runs["0"]
    matched = {}
    for mode, got in runs.items():
        if mode == "0":
            continue
        same = 0
        for r in range(rounds):
            if not all(r < len(got[i]) and r < len(base[i]) for i in base):
                continue
            check(all(np.array_equal(got[i][r].view(np.uint32), base[i][r].view(np.uint32))
                      for i in base), f"lanes={mode}: round {r}'s logits differ from thread "
                                      "mode's")
            same += 1
        matched[mode] = same
    return matched


def lane_ring_check(ring, mode):
    """No lane sat parked for more than two polls while a ring held work."""
    from nnstreamer_tpu_torch.graph import lanes

    check(ring["longest_parked_with_work_s"] <= 2 * lanes._POLL_S,
          f"lanes={mode}: a lane sat parked {ring['longest_parked_with_work_s']} s while a "
          "ready ring held a task")


def sleep_cycles(torch, seconds):
    """The ``torch.cuda._sleep`` cycles that hold the current stream for
    about ``seconds`` on this card (its rate timed with CUDA events)."""
    probe = 50_000_000
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(probe // 10)  # warm
    begin.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * seconds * 1e3 / begin.elapsed_time(end))


class SleepFilter:
    """A custom filter whose invoke enqueues ``torch.cuda._sleep`` on the
    current stream: device work that really is slow, for the watchdog's
    overdue-device verdict (the phase's own, not part of any path)."""

    def __init__(self, torch, spec, cycles):
        self.torch, self.spec, self.cycles = torch, spec, cycles

    def get_input_spec(self):
        return self.spec

    def get_output_spec(self):
        return self.spec

    def invoke(self, x):
        self.torch.cuda._sleep(self.cycles)
        return x + 1


def healthz(url):
    """``/healthz``'s HTTP status and document."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def wait_until(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.002)


def watchdog_phase_runs(torch, np, nns, faults, hooks, REGISTRY, desc, model, labels_n, card,
                        mode, cycles, dump_dir):
    """The watchdog with ``recover`` on slice 1 (a wedged queue, a source
    that stalls once) and on the _sleep filter (an overdue device, with a
    live breaker), under ``[dispatch] lanes`` = ``mode``.  Returns the
    times from each fault to its verdict and to its recovery record."""
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.obs.device import DeviceTracer
    from nnstreamer_tpu_torch.obs.export import MetricsServer
    from nnstreamer_tpu_torch.obs.watchdog import PipelineWatchdog
    from nnstreamer_tpu_torch.sched.breaker import CircuitBreaker
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

    out = {}
    marks = {}

    def mark(key):
        marks.setdefault(key, time.perf_counter())

    def on_health(pipeline, healthy, reason):
        mark("healthy" if healthy else "verdict")

    def on_recovery(pipeline, action, target, result):
        mark(f"recovery:{action}:{result}")

    def on_fault(point, kind, target):
        mark("fault")

    def watched(p, **kw):
        return p.attach_tracer(PipelineWatchdog(interval_s=WD_INTERVAL_S, stall_s=WD_STALL_S,
                                                recover=True, **kw))

    hooked = (("health", on_health), ("recovery", on_recovery), ("fault", on_fault))
    for name, fn in hooked:
        hooks.connect(name, fn)
    try:
        with dispatch_lanes(mode), MetricsServer(port=0) as ms:
            url = f"http://{ms.host}:{ms.port}/healthz"
            # (1) a wedged queue: 503, the gauge at 0, the stall dump, a drain, 200 again
            marks.clear()
            faults.install(f"queue_wedge@q:after={WD_WEDGE_AFTER},ms={WD_WEDGE_MS}")
            p = nns.parse_launch(desc(RECOVERY_FRAMES, labels_n, queue=WD_WEDGE_QUEUE))
            p.name = f"wd_wedge_{mode}"
            p["f"].model = model
            wd = watched(p)
            try:
                p.start()
                wait_until(lambda: not wd.health()[0], 30, "the wedged queue's verdict")
                code, doc = healthz(url)
                gauge = gauge_value(REGISTRY, "nnstpu_health", pipeline=p.name)
                reasons = list(wd.summary()["reasons"])
                check(p.wait(600), "the wedged run did not end")
                wait_until(lambda: wd.health()[0], 30, "health after the wedge")
                code_after, _ = healthz(url)
                rec = p.recovery_stats()
            finally:
                p.stop()
                faults.deactivate()
            delivered = len(p["out"].frames)
            dump = os.path.join(dump_dir, f"{p.name}.stall.trace.json")
            print(f"watchdog (lanes={mode}), wedged queue: /healthz {code} then {code_after}, "
                  f"nnstpu_health {gauge}, reasons {reasons}, {rec}, {delivered} delivered; "
                  f"fault to verdict {marks['verdict'] - marks['fault']:.4f} s, to the drain "
                  f"{marks['recovery:drain_queue:ok'] - marks['fault']:.4f} s [{card}]",
                  flush=True)
            check(code == 503 and [r.split(":")[0] for r in reasons] == ["wedged_queue"]
                  and p.name in doc["failures"], f"/healthz {code}: {doc}")
            check(gauge == 0.0 and os.path.exists(dump), f"gauge {gauge}, dump {dump}")
            check(rec["actions"].get("drain_queue", 0) >= 1 and code_after == 200,
                  f"drain and health: {rec}, /healthz {code_after}")
            check(delivered + rec["shed_total"] == RECOVERY_FRAMES, "delivered + shed != offered")
            out["wedged_queue"] = dict(
                fault_to_verdict_s=marks["verdict"] - marks["fault"],
                fault_to_recovery_s=marks["recovery:drain_queue:ok"] - marks["fault"],
                delivered=delivered, shed=rec["shed_total"], drains=rec["actions"]["drain_queue"])

            # (2) a source that stalls once: restarted, its later frames arrive
            marks.clear()
            p = nns.parse_launch(desc(RECOVERY_FRAMES, labels_n))
            p.name = f"wd_stall_{mode}"
            p["f"].model = model
            src = p["src"]
            stream = src.frames
            calls = []

            def stall_once():
                calls.append(1)
                if len(calls) == 1:
                    for i, f in enumerate(stream()):
                        if i == WD_STALL_AFTER:
                            mark("fault")
                            src._stop_evt.wait()
                            return
                        yield f
                yield from stream()

            src.frames = stall_once
            wd = watched(p)
            try:
                p.start()
                check(p.wait(600), "the stalled source's run did not end")
                wait_until(lambda: wd.health()[0], 30, "health after the restart")
                rec = p.recovery_stats()
            finally:
                p.stop()
            delivered = len(p["out"].frames)
            print(f"watchdog (lanes={mode}), stalled source: {rec}, {delivered} delivered "
                  f"({WD_STALL_AFTER} before the stall); fault to verdict "
                  f"{marks['verdict'] - marks['fault']:.4f} s, to the restart "
                  f"{marks['recovery:restart_source:ok'] - marks['fault']:.4f} s [{card}]",
                  flush=True)
            check(rec.get("actions", {}).get("restart_source", 0) >= 1 and len(calls) == 2,
                  f"restart_source: {rec}, frames() entered {len(calls)} times")
            check(delivered == WD_STALL_AFTER + RECOVERY_FRAMES,
                  f"{delivered} delivered, expected {WD_STALL_AFTER} + {RECOVERY_FRAMES}")
            out["stalled_source"] = dict(
                fault_to_verdict_s=marks["verdict"] - marks["fault"],
                fault_to_recovery_s=marks["recovery:restart_source:ok"] - marks["fault"],
                delivered=delivered)

            # (3) an overdue device: the _sleep filter, a live breaker tripped
            marks.clear()
            breaker = CircuitBreaker(failure_threshold=3, reset_timeout_s=60)
            spec = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(4,)))
            p = nns.Pipeline(name=f"wd_device_{mode}")
            sleeper = p.add(TensorFilter(framework="custom", name="f",
                                         model=SleepFilter(torch, spec, cycles)))
            p.link_chain(p.add(nns.make("datasrc", "s", data=[
                Frame.of(torch.zeros(4, device=DEVICE), pts=0)])), sleeper,
                p.add(nns.make("tensor_sink", "out")))
            dev = p.attach_tracer(DeviceTracer())

            def on_dispatch(node, frame, o, t0):
                marks.setdefault("fault", t0 / 1e9)  # the clock of perf_counter

            hooks.connect("device_dispatch", on_dispatch)
            trips = []
            wd = watched(p, device_deadline_s=WD_DEADLINE_S)
            try:
                p.start()
                wait_until(lambda: not wd.health()[0], 30, "the overdue device's verdict")
                reasons = list(wd.summary()["reasons"])
                check(p.wait(600), "the overdue device's run did not end")
                wait_until(lambda: wd.health()[0], 30, "health after the device completed")
                trips.append(breaker.stats())
                rec = counter_sum(REGISTRY, "nnstpu_recovery_total", pipeline=p.name,
                                  action="breaker_trip", result="ok")
            finally:
                p.stop()
                hooks.disconnect("device_dispatch", on_dispatch)
            print(f"watchdog (lanes={mode}), overdue device: reasons {reasons}, breaker "
                  f"{trips[0]}, breaker_trip ok {rec}, device tracer {dev.summary()['completed']} "
                  f"completed; fault to verdict {marks['verdict'] - marks['fault']:.4f} s, to "
                  f"the breaker trip {marks['recovery:breaker_trip:ok'] - marks['fault']:.4f} s "
                  f"[{card}]", flush=True)
            check(any(r.startswith("overdue_device:f") for r in reasons), f"reasons {reasons}")
            check(trips[0]["state"] == "open" and trips[0]["forced_trips"] >= 1 and rec >= 1,
                  f"breaker {trips[0]}, breaker_trip ok {rec}")
            out["overdue_device"] = dict(
                fault_to_verdict_s=marks["verdict"] - marks["fault"],
                fault_to_recovery_s=marks["recovery:breaker_trip:ok"] - marks["fault"],
                breaker=trips[0])
    finally:
        for name, fn in hooked:
            hooks.disconnect(name, fn)
    return out


def lanes_phase(torch, np, K, root, card, keep):
    """The dispatcher lanes at full width: config 5 (8 streams, int8 head)
    in three modes, slice 1 in two lane modes against thread mode (with the
    device tracer's wakeups, and a live source promoted to a helper), config
    1d under lanes=auto, the recovery phase's restart case under two
    lanes, and the
    watchdog's three verdicts with recovery in thread mode and under
    lanes=auto."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch import faults
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.graph import lanes
    from nnstreamer_tpu_torch.obs import hooks
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY

    total = {}
    K.reset_launches()
    with dispatch_lanes("auto"):
        res = {"auto_lanes": lanes.configured_lanes()}
    batch = keep["batch"]
    n = BATCH_STREAMS[1]
    kernels = ("fused_arith", "int8_matmul")
    desc = batch_desc(n, batch["ckpt"], "build_quantized,int8_head=1")
    rng = np.random.default_rng(16)
    frames = [[Frame.of(torch.from_numpy(rng.integers(0, 256, (IMAGE, IMAGE, 3),
                                                      dtype=np.uint8)), pts=r)
               for r in range(BATCH_ROUNDS)] for _ in range(n)]

    # (a) config 5, 8 streams, in each mode
    runs, per_mode = {}, {}
    for mode in LANE_MODES:
        state = {}

        def setup(p, state=state):
            state["ring"] = RingSampler(p)
            state["name"] = p.name
            state["steals"] = counter_sum(REGISTRY, "nnstpu_lane_steals_total", pipeline=p.name)
            state["handoffs"] = counter_sum(REGISTRY, "nnstpu_lane_handoffs_total",
                                            pipeline=p.name)

        def on_start(p, state=state):
            state["captures_at_start"] = p["f"].backend.stats["captures"]

        def during(p, state=state):
            be = p["f"].backend
            state.update(stats=dict(be.stats), lanes=p.stats().get("lanes"),
                         launches={k.__name__: k.launches for k in K.KERNELS})
            with torch.inference_mode():
                state["eager"] = [be.eager(torch.stack([frames[i][r].tensor(0)
                                                        for i in range(n)]).cuda())[0]
                                  .cpu().numpy() for r in range(BATCH_ROUNDS)]

        with dispatch_lanes(mode):
            take_launches(K, total)
            try:
                p, got, arrivals, _ = run_batch(nns, torch, desc, n, frames, setup=setup,
                                                during=during, on_start=on_start)
            finally:
                ring = state["ring"].stop()
            take_launches(K, total, state["launches"])
        batch_capture_check(state["stats"], BATCH_ROUNDS, state["launches"], kernels)
        stream_check(np, got, state["eager"], BATCH_ROUNDS)
        check(state["captures_at_start"] == state["stats"]["captures"],
              f"lanes={mode}: {state['stats']['captures'] - state['captures_at_start']} "
              "captures while PLAYING")
        r = rates(arrivals, np)
        steals = counter_sum(REGISTRY, "nnstpu_lane_steals_total",
                             pipeline=state["name"]) - state["steals"]
        handoffs = counter_sum(REGISTRY, "nnstpu_lane_handoffs_total",
                               pipeline=state["name"]) - state["handoffs"]
        if mode != "0":
            check(state["lanes"] is not None and state["lanes"]["promoted"] == [],
                  f"lanes={mode}: stats {state['lanes']}")
            lane_ring_check(ring, mode)
        runs[mode] = got
        per_mode[mode] = dict(frames_per_s=r["fps"] * n, rounds_per_s=r["fps"],
                              p50_ms=r["p50_ms"], p90_ms=r["p90_ms"], lanes=state["lanes"],
                              steals=steals, handoffs=handoffs, ring=ring,
                              replays=state["stats"]["replays"])
        print(f"lanes (a) config 5, {n} streams, int8 head, lanes={mode}: "
              f"{per_mode[mode]['frames_per_s']} frames/s over all streams, p50 {r['p50_ms']} "
              f"ms a round; stats()['lanes'] {state['lanes']}; steals {steals}, handoffs "
              f"{handoffs}; ring sampler {ring} [{card}]", flush=True)
    matched = rounds_matched(np, runs, BATCH_ROUNDS)
    print(f"lanes (a): rounds bit for bit equal to thread mode's: {matched} of {BATCH_ROUNDS}; "
          f"no capture while PLAYING in any mode [{card}]", flush=True)
    check(all(v == BATCH_ROUNDS for v in matched.values()), f"matched rounds {matched}")
    res["config5"] = dict(modes=per_mode, rounds_matched=matched)
    with dispatch_lanes("auto"):
        take_launches(K, total)
        traced = dict(fps=per_mode["auto"]["rounds_per_s"])
        samplers = []
        tr = profile_path(lambda m: run_batch(nns, torch, desc, n, [f[:m] for f in frames],
                                              setup=lambda p: samplers.append(RingSampler(p)),
                                              traced=True)[3], traced, kernels)
        rings = [r.stop() for r in samplers]
        for ring in rings:
            lane_ring_check(ring, "auto (traced)")
        res["config5"]["traced_auto"] = dict(ring=rings[-1], kernel_records=tr["records"],
                                             device_busy_ms_per_round=traced[
                                                 "device_busy_ms_per_frame"],
                                             device_idle_share=traced["device_idle_share"],
                                             host_ops_per_round=traced["host_ops_per_frame"])
    check(all(tr["records"][k] > 0 for k in kernels), f"lanes=auto trace: {tr['records']}")
    print(f"lanes (a) traced under lanes=auto: kernel records {tr['records']}, device busy "
          f"{traced['device_busy_ms_per_frame']} ms a round, idle share "
          f"{traced['device_idle_share']}; ring sampler {rings[-1]} [{card}]", flush=True)

    # (b) slice 1, 64 frames: lanes=1 and lanes=auto against thread mode
    _, model, _, _ = keep["image_labeling"]
    labels = os.path.join(root, "build", "chip_smoke", "labels_1001.txt")
    slice_desc = recovery_desc(RECOVERY_FRAMES, labels)
    wakeups = [0]
    wakeup = lanes.device_wakeup

    def counting_wakeup():
        wakeups[0] += 1
        wakeup()

    slices = {}
    for mode in ("0",) + LANE_SLICE_MODES + ("auto+device",):
        state = {"arrivals": []}

        def setup(p, state=state, mode=mode):
            p["out"].connect("new-data", lambda f: state["arrivals"].append(time.perf_counter()))
            state["ring"] = RingSampler(p)
            if mode.endswith("+device"):
                state["device"] = p.attach_tracer("device")

        def during(p, state=state):
            state["lanes"] = p.stats().get("lanes")

        lanes.device_wakeup = counting_wakeup
        try:
            with dispatch_lanes(mode.split("+")[0]):
                take_launches(K, total)
                p, outs, _, _, _, _ = faulted_run(nns, faults, hooks, slice_desc, model, None,
                                                  None, setup=setup, during=during)
        finally:
            lanes.device_wakeup = wakeup
            ring = state["ring"].stop()
        got = p["out"].frames
        check(len(got) == RECOVERY_FRAMES, f"slice 1, lanes={mode}: {len(got)} frames")
        r = rates(state["arrivals"], np)
        slices[mode] = dict(labels={f.pts: f.meta["label_index"] for f in got},
                            outs={pts: o for pts, o in outs}, fps=r["fps"], p50_ms=r["p50_ms"],
                            lanes=state["lanes"], ring=ring)
        if "device" in state:
            summ = state["device"].summary()
            slices[mode].update(wakeups=wakeups[0], reaped=summ["completed"])
            check(wakeups[0] >= RECOVERY_FRAMES and summ["completed"] == RECOVERY_FRAMES,
                  f"device_wakeup reached {wakeups[0]} times, {summ['completed']} reaped")
        if mode != "0":
            lane_ring_check(ring, mode)
    base = slices["0"]
    for mode in LANE_SLICE_MODES + ("auto+device",):
        s = slices[mode]
        check(s["labels"] == base["labels"], f"slice 1, lanes={mode}: labels differ")
        check(sorted(s["outs"]) == sorted(base["outs"]) and all(
            bitwise_equal(torch, s["outs"][k], base["outs"][k]) for k in base["outs"]),
            f"slice 1, lanes={mode}: logits differ from thread mode's")
    res["slice1"] = {m: {k: v for k, v in s.items() if k not in ("labels", "outs")}
                     for m, s in slices.items()}
    print(f"lanes (b) slice 1, {RECOVERY_FRAMES} frames: labels and logits under lanes=1 and "
          f"lanes=auto (and with the device tracer) bit for bit thread mode's; fps " + ", ".join(
              f"lanes={m} {s['fps']}" for m, s in slices.items()) +
          f"; device_wakeup reached {slices['auto+device']['wakeups']} times, "
          f"{slices['auto+device']['reaped']} reaped [{card}]", flush=True)
    # a live source is a blocking boundary: promoted to a helper at start
    with dispatch_lanes("auto"):
        take_launches(K, total)
        before = counter_sum(REGISTRY, "nnstpu_lane_promotions_total", reason="hint",
                             result="ok")
        live = {}
        p, _, _, _, _, _ = faulted_run(nns, faults, hooks, recovery_desc(RECOVERY_FRAMES, labels,
                                                                         live=True),
                                       model, None, None,
                                       during=lambda p: live.update(p.stats()["lanes"]))
        promoted = counter_sum(REGISTRY, "nnstpu_lane_promotions_total", reason="hint",
                               result="ok") - before
    print(f"lanes (b) live source under lanes=auto: promoted {live['promoted']}, "
          f"nnstpu_lane_promotions_total{{reason=hint}} +{promoted}, "
          f"{len(p['out'].frames)} frames [{card}]", flush=True)
    check(live["promoted"] == ["src:src"] and promoted == 1 and
          len(p["out"].frames) == RECOVERY_FRAMES, f"live source: {live}, +{promoted}")
    res["slice1"]["live_promoted"] = live["promoted"]

    # (c) config 1d under lanes=auto: every bucket before PLAYING
    dyn_frames, poly = batch["dyn_frames"], batch["poly"]
    os.environ["NNSTPU_COMPILE_WARMUP"] = "1"
    batches, got_dyn, arrivals = [], [], []
    try:
        with dispatch_lanes("auto"):
            take_launches(K, total)
            p = nns.parse_launch(dyn_desc())
            p["s"].data = [Frame.of(x, pts=i) for i, x in enumerate(dyn_frames)]
            p["f"].model = poly
            push = p["dyn"].push

            def recording_push(frame, pad_name=None):
                batches.append((list(frame.meta["dynbatch"]["pts"]),
                                int(frame.tensors[0].shape[0])))
                push(frame, pad_name)

            p["dyn"].push = recording_push
            p["out"].connect("new-data", lambda f: (got_dyn.append((f.pts, f.tensor(0).numpy())),
                                                    arrivals.append(time.perf_counter())))
            gate = p["u"]._lock
            gate.acquire()
            try:
                p.start()
            except BaseException:
                gate.release()
                raise
            try:
                be = p["f"].backend
                before = be.stats["captures"]
                gate.release()
                check(p.wait(600), "config 1d under lanes did not finish")
                take_launches(K, total)  # before the eager forwards
                eager = {}
                with torch.inference_mode():
                    for pts, b in batches:
                        x = torch.stack([dyn_frames[i] for i in pts] +
                                        [dyn_frames[pts[-1]]] * (b - len(pts))).cuda()
                        eager[tuple(pts)] = be.eager(x)[0].cpu().numpy()
                K.reset_launches()  # the eager forwards compare; they are not the path's
                after = be.stats["captures"]
                report = p.warmup_report
            finally:
                p.stop()
    finally:
        os.environ.pop("NNSTPU_COMPILE_WARMUP", None)
    buckets = [b for _, b in batches]
    hist = dyn_checks(np, before, after, report, buckets, [pts for pts, _ in got_dyn],
                      DYN_FRAMES)
    by_pts = dict(got_dyn)
    for pts, b in batches:
        for j, f in enumerate(pts):
            check(np.array_equal(by_pts[f].view(np.uint32), eager[tuple(pts)][j].view(np.uint32)),
                  f"config 1d under lanes: frame {f} differs from the eager forward of its batch")
    r = rates(arrivals, np)
    res["config1d"] = dict(buckets=hist, captures_before_playing=before, fps=r["fps"])
    print(f"lanes (c) config 1d under lanes=auto: {before} captures before the first frame, none "
          f"while PLAYING; {DYN_FRAMES} frames in pts order, rows equal to the eager forward of "
          f"their batch bit for bit; buckets {hist}; {r['fps']} frames/s [{card}]", flush=True)

    # (d) the recovery phase's case (a) under two lanes
    restart = dict(mode="restart", backoff_ms=1, backoff_cap_ms=5, max_restarts=8)
    faults_n = RECOVERY_FRAMES // RESTART_EVERY
    with dispatch_lanes(LANE_RESTART_MODE):
        take_launches(K, total)
        p, outs, walls, _, eng, _ = faulted_run(
            nns, faults, hooks, slice_desc, model, f"invoke_raise@f:every={RESTART_EVERY}",
            restart)
    got = p["out"].frames
    rec, stats = p.recovery_stats(), dict(p["f"].backend.stats)
    print(f"lanes (d) restart under lanes={LANE_RESTART_MODE}: {len(got)} of {RECOVERY_FRAMES} "
          f"delivered, {rec}, backend {stats}, restart walls {[round(w, 4) for w in walls]} "
          f"[{card}]", flush=True)
    check(len(got) == RECOVERY_FRAMES - faults_n and stats["captures"] == faults_n + 1,
          f"delivered {len(got)}, captures {stats['captures']}")
    check(rec.get("actions") == {"restart_node": faults_n} and rec.get("shed_total") == faults_n,
          f"recovery ledger {rec}")
    check(all(f.meta["label_index"] == base["labels"][f.pts] for f in got),
          "a label differs from the fault-free run's frame")
    res["restart"] = dict(delivered=len(got), captures=stats["captures"], recovery=rec,
                          restart_wall_s=walls)

    # (e) the watchdog's three verdicts, in thread mode and under lanes=auto
    dump_dir = os.path.join(root, "build", "chip_smoke", "stall_dumps")
    os.makedirs(dump_dir, exist_ok=True)
    os.environ["NNSTPU_OBS_FLIGHT_DUMP_DIR"] = dump_dir
    cycles = sleep_cycles(torch, WD_SLEEP_S)
    try:
        take_launches(K, total)
        res["watchdog"] = {mode: watchdog_phase_runs(
            torch, np, nns, faults, hooks, REGISTRY, recovery_desc, model, labels, card, mode,
            cycles, dump_dir) for mode in ("0", "auto")}
    finally:
        os.environ.pop("NNSTPU_OBS_FLIGHT_DUMP_DIR", None)
    res["watchdog"]["sleep_cycles"] = cycles
    take_launches(K, total)
    check(total["fused_arith"] > 0 and total["int8_matmul"] > 0, f"lanes launches {total}")
    return total, res


# -- the deep-profiling lane (obs/profiler.py) ----------------------------------

PROFILE_FRAMES = 64            # slice 1's frames inside the first capture window
PROFILE_WINDOW_S = 2.0         # the window: the frames, and the device tracer's completions
# The capture's device time a frame over traced_run's CUPTI busy time a frame
# (slice 1's, from the slice phase): the same kernels, timed by the same
# tracer in two windows of one process.
PROFILE_BUSY_BAND = (0.8, 1.25)
PROFILE_CATEGORIES = ("matmul", "conv", "elementwise", "copy", "infeed", "other")
AUTO_FRAMES = 600              # the auto-capture run's stream
AUTO_BASELINE = 48             # completions before the device stall (> min samples)
AUTO_MIN_SAMPLES = "16"        # [obs] profile_min_samples of the run
# a _sleep ahead of one replay on the filter's stream: far above the band,
# which three sigmas of the run's first dispatches (the slowest) widen
AUTO_STALL_S = 0.5
WHOLE_RUN_FRAMES = 16          # the [common] xplane_trace_dir run


def kernel_rows(rows, wrapper):
    """The table rows of a wrapper's kernels, and their summed count."""
    mine = [r for r in rows if any(s in r["name"] for s in KERNEL_SYMBOLS[wrapper])]
    return mine, sum(r["count"] for r in mine)


def profile_phase(torch, np, K, root, card, keep, busy_ms):
    """The deep-profiling lane over a PLAYING slice 1: a capture window
    (its device table against the frames and the traced busy time, the
    typed busy error, /profile's 409 meanwhile and 200 after), the
    watchdog's profile_auto on a device stall, the whole-run trace of
    [common] xplane_trace_dir, and the captured graphs' memory ledger."""
    import shutil
    import threading
    import urllib.error
    import urllib.request

    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.obs import hooks, profiler
    from nnstreamer_tpu_torch.obs.export import MetricsServer, unregister_degraded
    from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
    from nnstreamer_tpu_torch.obs.watchdog import PipelineWatchdog

    desc, model, _, kernels = keep["image_labeling"]
    work = os.path.join(root, "build", "chip_smoke", "profile")
    shutil.rmtree(work, ignore_errors=True)
    env = {"NNSTPU_OBS_PROFILE_DIR": os.path.join(work, "gallery"),
           "NNSTPU_OBS_PROFILE_TOP_K": "100000", "NNSTPU_OBS_PROFILE_KEEP": "16",
           "NNSTPU_OBS_PROFILE_MAX_BYTES": str(1 << 31)}
    saved = {k: os.environ.get(k) for k in list(env) + [
        "NNSTPU_OBS_PROFILE_AUTO", "NNSTPU_OBS_PROFILE_AUTO_SECONDS",
        "NNSTPU_OBS_PROFILE_AUTO_COOLDOWN_S", "NNSTPU_OBS_PROFILE_MIN_SAMPLES",
        "NNSTPU_COMMON_XPLANE_TRACE_DIR"]}
    os.environ.update(env)
    profiler.reset_gallery()
    res = {}
    srv = MetricsServer(port=0).start()
    url = f"http://127.0.0.1:{srv.port}/profile"

    def get(query):
        try:
            with urllib.request.urlopen(f"{url}?{query}", timeout=120) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read().decode())

    try:
        # (a) one capture window over slice 1 while it plays; the upload's
        # lock holds the source until the profiler runs, so the window holds
        # every frame and no capture
        K.reset_launches()
        p = nns.parse_launch(desc(PROFILE_FRAMES))
        p["f"].model = model
        p.attach_tracer("device")
        delivered = []
        p["out"].connect("new-data", delivered.append)
        gate = p["u"]._lock
        gate.acquire()
        try:
            p.start()
        except BaseException:
            gate.release()
            raise
        box = {}

        def capture():
            try:
                box["summary"] = profiler.capture_profile(seconds=PROFILE_WINDOW_S, pipeline=p)
            except BaseException as exc:  # noqa: BLE001 - checked below
                box["error"] = exc

        t = threading.Thread(target=capture, name="chip_smoke-capture")
        try:
            t.start()
            import torch.autograd.profiler as autograd_profiler

            if hasattr(autograd_profiler, "_is_profiler_enabled"):
                wait_until(lambda: autograd_profiler._is_profiler_enabled or not t.is_alive(),
                           60, "the profiler's start")
            else:  # this PyTorch keeps no flag: the start takes at most a few seconds
                time.sleep(5.0)
            time.sleep(0.25)
            cost_key = p["f"].backend.cost_key()
            gate.release()
            gate = None
            try:
                profiler.capture_profile(seconds=0.1)
                fail("a second capture during the first did not raise ProfileBusyError")
            except profiler.ProfileBusyError as exc:
                res["busy_error"] = str(exc)
            status, doc = get("seconds=1")
            check(status == 409 and doc.get("error") == "busy",
                  f"GET /profile during a capture answered {status}: {doc}")
            res["http_during"] = status
            t.join(120)
            check(p.wait(120), "the profiled slice did not finish")
        finally:
            if gate is not None:
                gate.release()
            p.stop()
        launches = {k.__name__: k.launches for k in K.KERNELS}
        check("error" not in box, f"capture_profile failed: {box.get('error')!r}")
        check(len(delivered) == PROFILE_FRAMES,
              f"the profiled run delivered {len(delivered)} of {PROFILE_FRAMES}")
        s = box["summary"]
        frames, rows = s["frames_observed"], s["ops"]
        check(not s["aborted"], f"the window was abandoned: {s['aborted']}")
        check(s["device_planes"] == 1 and s["ops_total"] == len(rows),
              f"the capture's table: {s['device_planes']} devices, {len(rows)} of "
              f"{s['ops_total']} rows")
        check(frames == PROFILE_FRAMES, f"{frames} device_exec completions in the window, "
                                        f"{PROFILE_FRAMES} frames sent")
        counts = {}
        for w in kernels:
            mine, counts[w] = kernel_rows(rows, w)
            check(mine, f"the capture's table has no row of {w}")
            # one record a frame; CUPTI may drop the first record of a
            # trace's first graph launch (ROADMAP queue B)
            check(abs(counts[w] - frames) <= 1,
                  f"{w}: {counts[w]} records in the table for {frames} frames")
        bad = [r for r in rows if r["category"] not in PROFILE_CATEGORIES]
        check(not bad, f"rows without a category: {bad[:3]}")
        check(cost_key in s["executables"] and
              s["executables"][cost_key]["dispatches"] == frames,
              f"the filter's graph {cost_key} is not what the window observed: "
              f"{s['executables']}")
        check(all(r.get("executable") == cost_key for r in rows),
              "a row is not attributed to the filter's graph")
        us_frame = s["device_us_total"] / max(frames, 1)
        ratio = us_frame / 1e3 / busy_ms
        check(PROFILE_BUSY_BAND[0] <= ratio <= PROFILE_BUSY_BAND[1],
              f"the capture's {us_frame:.1f} us a frame is {ratio:.3f} of traced_run's "
              f"{busy_ms * 1e3:.1f}, outside {PROFILE_BUSY_BAND}")
        top = sorted(s["op_categories"].items(), key=lambda kv: -kv[1])
        res.update(frames_observed=frames, kernel_records=counts, rows=len(rows),
                   device_us_per_frame=us_frame, busy_ratio_to_traced_run=ratio,
                   op_categories_us=dict(top), window_s=s["seconds"],
                   trace_bytes=sum(os.path.getsize(os.path.join(s["artifact_dir"], a))
                                   for a in s["artifacts"]),
                   top_ops=[(r["name"][:80], r["category"], r["dur_us"], r["count"])
                            for r in rows[:5]])
        print(f"profile window over slice 1: {frames} frames, {len(rows)} device ops, "
              f"{us_frame:.2f} us a frame on the device ({ratio:.3f} of traced_run's busy "
              f"time), records {counts}, by category {dict(top)} [{card}]", flush=True)

        # (b) GET /profile after the window: 200 with the summary
        t0 = time.perf_counter()
        status, doc = get("seconds=1")
        check(status == 200 and doc.get("trigger") == "http" and
              doc.get("requested_seconds") == 1.0 and "ops_total" in doc,
              f"GET /profile answered {status}: {str(doc)[:300]}")
        res["http_after"] = dict(status=status, wall_s=time.perf_counter() - t0,
                                 ops_total=doc["ops_total"])

        # (c) [obs] profile_auto: a device stall ahead of one replay makes the
        # watchdog bank exactly one capture (the cooldown outlasts the run)
        os.environ.update({"NNSTPU_OBS_PROFILE_AUTO": "true",
                           "NNSTPU_OBS_PROFILE_AUTO_SECONDS": "0.5",
                           "NNSTPU_OBS_PROFILE_AUTO_COOLDOWN_S": "600",
                           "NNSTPU_OBS_PROFILE_MIN_SAMPLES": AUTO_MIN_SAMPLES})
        cycles = sleep_cycles(torch, AUTO_STALL_S)
        before = sum(c["trigger"] == "watchdog" for c in profiler.recent_captures())
        reg = MetricsRegistry()
        wd = PipelineWatchdog(registry=reg, interval_s=0.02)
        seen = [0]

        def count(*_):
            seen[0] += 1

        p = nns.parse_launch(desc(AUTO_FRAMES))
        p["f"].model = model
        p.attach_tracer("device")
        p.attach_tracer(wd)
        hooks.connect("device_exec", count)
        try:
            p.start()
            wait_until(lambda: seen[0] >= AUTO_BASELINE, 60, "the auto run's baseline")
            torch.cuda._sleep(cycles)  # the filter replays on this default stream
            deadline = time.monotonic() + 60
            while wd.summary()["profile_auto"]["captures"] < 1:
                if time.monotonic() > deadline:
                    det = wd._profile_detector
                    with det._lock:
                        stats = {k: v.snapshot() for k, v in det._stats.items()}
                    fail(f"no watchdog capture within 60 s: {det.verdicts} verdicts, "
                         f"{seen[0]} completions, the detector's aggregates {stats}")
                time.sleep(0.01)
            check(p.wait(120), "the auto-capture run did not finish")
            time.sleep(0.3)
            summ = wd.summary()["profile_auto"]
        finally:
            hooks.disconnect("device_exec", count)
            p.stop()
            for k in ("NNSTPU_OBS_PROFILE_AUTO", "NNSTPU_OBS_PROFILE_AUTO_SECONDS",
                      "NNSTPU_OBS_PROFILE_AUTO_COOLDOWN_S", "NNSTPU_OBS_PROFILE_MIN_SAMPLES"):
                os.environ.pop(k, None)
        autos = [c for c in profiler.recent_captures() if c["trigger"] == "watchdog"]
        check(summ["captures"] == 1 and len(autos) - before == 1,
              f"the watchdog banked {summ['captures']} captures ({len(autos) - before} in "
              "the gallery's memory), expected exactly one")
        check(counter_sum(reg, "nnstpu_profile_captures_total", trigger="watchdog",
                          outcome="ok") == 1, "nnstpu_profile_captures_total{watchdog,ok} != 1")
        last = autos[-1]
        check(last["pipeline"] == p.name and not last["aborted"],
              f"the auto capture: {last['pipeline']!r}, aborted {last['aborted']!r}")
        res["auto"] = dict(captures=summ["captures"], verdicts=summ["verdicts"],
                           stall_s=AUTO_STALL_S, rows=last["ops_total"],
                           frames_observed=last["frames_observed"])
        print(f"profile_auto: a {AUTO_STALL_S * 1e3:.0f} ms device stall gave "
              f"{summ['verdicts']} verdicts and {summ['captures']} capture (trigger watchdog, "
              f"{last['frames_observed']} frames, {last['ops_total']} rows)", flush=True)

        # (d) [common] xplane_trace_dir: a Kineto trace of the whole PLAYING
        # run, and (e) the memory ledger read while that run's graph is live
        trace_dir = os.path.join(work, "whole_run")
        os.environ["NNSTPU_COMMON_XPLANE_TRACE_DIR"] = trace_dir

        def read_ledger(pl):
            """The ledger of the graphs alive now, and the capacity check
            against the card and against 1 byte."""
            live = pl["f"].backend.cost_key()
            ledger = profiler.hbm_ledger()
            report = profiler.check_hbm_capacity()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                low = profiler.check_hbm_capacity(capacity_bytes=1)
            unregister_degraded("hbm:pipeline")
            warned = any(issubclass(w.category, profiler.HbmCapacityWarning) for w in caught)
            return live, ledger, report, low, warned

        try:
            _, _, (live_key, ledger, report, low, warned) = run_pipeline(
                nns, desc(WHOLE_RUN_FRAMES), model, WHOLE_RUN_FRAMES, during=read_ledger)
        finally:
            os.environ.pop("NNSTPU_COMMON_XPLANE_TRACE_DIR", None)
        files = profiler.find_trace_files(trace_dir)
        last = profiler.last_capture()
        check(len(files) == 1 and last["trigger"] == "whole_run" and
              last["artifact_dir"] == trace_dir,
              f"the whole-run trace: files {files}, last capture {last.get('trigger')}")
        whole = {}
        for w in kernels:
            _, whole[w] = kernel_rows(last["ops"], w)
            check(WHOLE_RUN_FRAMES - 1 <= whole[w] <= WHOLE_RUN_FRAMES,
                  f"the whole-run trace holds {whole[w]} records of {w} for "
                  f"{WHOLE_RUN_FRAMES} frames")
        res["whole_run"] = dict(frames=WHOLE_RUN_FRAMES, records=whole,
                                trace_bytes=os.path.getsize(files[0]),
                                device_planes=last["device_planes"])
        print(f"whole-run trace: {os.path.basename(files[0])}, "
              f"{os.path.getsize(files[0])} bytes, records {whole}", flush=True)

        # (e) the ledger holds the graphs alive while that run played (the
        # graphs of stopped pipelines left it with their pools) and names the
        # largest; slice 1's graph leaves it when its pipeline stops
        rows_by = ledger.get("executables") or {}
        check(live_key in rows_by, "the ledger misses slice 1's live graph")
        largest = max(rows_by, key=lambda fp: rows_by[fp]["resident_bytes"], default=None)
        check(ledger.get("largest_resident") == largest,
              "the ledger names another largest graph")
        mine = rows_by.get(live_key, {})
        check(mine.get("output_bytes") == CLASSES * 4 and mine.get("temp_bytes", 0) > 0 and
              mine.get("parameter_bytes", 0) > 0, f"slice 1's ledger row: {mine}")
        check(live_key not in (profiler.hbm_ledger().get("executables") or {}),
              "slice 1's graph stayed in the ledger after its pipeline stopped")
        free, total = torch.cuda.mem_get_info()
        check(report["capacity_bytes"] == total and not report["over_capacity"],
              f"check_hbm_capacity against the card: {report}")
        check(low["over_capacity"] and warned,
              "capacity_bytes=1 did not warn HbmCapacityWarning")
        res["hbm"] = dict(graphs=len(rows_by), largest=largest,
                          largest_resident_bytes=rows_by.get(largest, {}).get("resident_bytes"),
                          resident_estimate_bytes=ledger.get("resident_estimate_bytes"),
                          capacity_bytes=total, slice1=mine)
        print(f"memory ledger while slice 1 plays: {len(rows_by)} live graphs, "
              f"{res['hbm']['resident_estimate_bytes']} bytes resident in all, largest "
              f"{largest} ({res['hbm']['largest_resident_bytes']} bytes); slice 1's graph "
              f"{mine}; card {total} bytes [{card}]", flush=True)
    finally:
        srv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        profiler.reset_gallery()
    return launches, res


# -- streaming training (training.py, tensor_trainer) ----------------------------

TRAIN_BATCH = 32
TRAIN_STEPS = 40
TRAIN_OPTIMIZER = "sgd,lr=0.001,momentum=0.9"
TRAIN_SEED = 17
TRAIN_CPU_LOSS_REL = 3e-2  # the first loss: bfloat16 convs on the card against the CPU's
TRAIN_EAGER_STEPS = 3      # captured steps held against eager steps on the card
TRAIN_EAGER_LOSS_REL = 1e-2
TRAIN_EAGER_PARAM_SHARE = 0.05  # params apart, as a share of how far they moved
TRAIN_DEPLOY_FRAMES = 8
TRAIN_DEPLOY_REL = 1e-3    # the deployed replay against eager apply (as slice 1's)
TRAIN_TRACE_STEPS = 8
TRAIN_RATE_STEPS = 48      # the ungated run that times steps/s
TRAIN_RATE_SKIP = 4        # its first steps (the capture among them) left out of the rate


def train_desc():
    """The training path: a uint8 batch, normalized by fused_arith, muxed
    with its int32 labels into tensor_trainer, the loss curve to a sink."""
    return ("tensor_mux name=m sync_mode=nosync ! "
            f"tensor_trainer name=tr loss=softmax_ce optimizer={TRAIN_OPTIMIZER} ! "
            "tensor_sink name=out "
            f"datasrc name=x ! tensor_transform mode=arithmetic option={NORMALIZE} "
            "acceleration=pallas ! m.sink_0 datasrc name=y ! m.sink_1")


class GatedBatches:
    """The batch source's data: one batch a step, the next yielded once the
    trainer's step has left the sink, so that no normalized batch waits in
    the mux while memory is read.  This lock-step pace adds a host round
    trip a step: the rate is timed on an ungated run."""

    def __init__(self, item, n):
        import threading

        self.item, self.n = item, n
        self.turn = threading.Semaphore(1)

    def __getitem__(self, i):  # the source's spec reads the first item
        return self.item

    def __iter__(self):
        for _ in range(self.n):
            self.turn.acquire()
            yield self.item


def diff_leaves(torch, tree):
    from nnstreamer_tpu_torch.training import tree_flatten

    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def train_phase(torch, np, K, ops, root, card, keep):
    """MobileNet-v2 1.0 trained on the card at batch 32, 224x224: the
    captured step against the CPU's loss and eager steps, the loss on a
    fixed batch, constant memory and parameters updated in place, the
    normalize's launches, the train -> deploy loop through slice 1's
    string, the step's memory in the ledger, and the step's rates on an
    ungated run."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch import training
    from nnstreamer_tpu_torch.obs import profiler
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.models import mobilenet_v2

    def apply(p, x):
        return mobilenet_v2.apply(p, x, dtype=torch.bfloat16)

    rng = np.random.default_rng(TRAIN_SEED)
    xb = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8))
    yb = torch.from_numpy(rng.integers(0, CLASSES, TRAIN_BATCH).astype(np.int32))
    params = mobilenet_v2.init_params(seed=0, num_classes=CLASSES, device=DEVICE)
    p = nns.parse_launch(train_desc())
    p["tr"].model = TorchModel(apply=apply, params=params, name="mobilenet_v2_train",
                               device=DEVICE)
    gated = GatedBatches(xb, TRAIN_STEPS)
    p["x"].data = gated
    p["y"].data = [yb] * TRAIN_STEPS
    losses = torch.zeros(TRAIN_STEPS, device=DEVICE)
    marks, arrivals, snap = {}, [], {}

    def on_frame(f):
        step = int(f.tensor(1))
        losses[step - 1].copy_(f.tensor(0))
        arrivals.append(time.perf_counter())
        tr = p["tr"]
        if step == TRAIN_EAGER_STEPS:
            snap["params"] = [t.detach().to("cpu", copy=True)
                              for t in diff_leaves(torch, tr._params)]
        if step in (2, TRAIN_STEPS):
            state = diff_leaves(torch, tr._params) + training._state_tensors(tr._opt_state)
            marks[step] = (torch.cuda.memory_allocated(), [t.data_ptr() for t in state])
        gated.turn.release()

    p["out"].connect("new-data", on_frame)
    K.reset_launches()
    t0 = time.perf_counter()
    p.start()
    try:
        check(p.wait(600), "the training run did not finish")
    finally:
        p.stop()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in K.KERNELS}
    tr = p["tr"]
    curve = losses.cpu().tolist()
    check(tr.step_count == TRAIN_STEPS and len(arrivals) == TRAIN_STEPS,
          f"step_count {tr.step_count}, {len(arrivals)} loss frames, {TRAIN_STEPS} sent")
    check(launches["fused_arith"] == TRAIN_STEPS and launches["int8_matmul"] == 0 and
          launches["pallas_nms_keep"] == 0,
          f"the training path's wrapper launches {launches}: fused_arith once a step")
    check(all(np.isfinite(curve)), f"a loss is not finite: {curve}")
    check(curve[-1] < 0.5 * curve[0], f"the loss on a fixed batch went {curve[0]} -> "
                                      f"{curve[-1]}, not below half")
    check(marks[2][1] == marks[TRAIN_STEPS][1], "a parameter or state tensor moved")
    check(marks[2][0] == marks[TRAIN_STEPS][0],
          f"device memory in use went {marks[2][0]} -> {marks[TRAIN_STEPS][0]} bytes "
          f"between step 2 and step {TRAIN_STEPS}")
    # the captured step's memory in the ledger: the parameters and the
    # optimizer state as its parameter bytes, its pool as its temp bytes
    state_bytes = sum(t.numel() * t.element_size() for t in diff_leaves(torch, tr._params) +
                      training._state_tensors(tr._opt_state))
    steps = {fp: r for fp, r in (profiler.hbm_ledger().get("executables") or {}).items()
             if fp.startswith("train_step:")}
    check(len(steps) == 1, f"the ledger holds {len(steps)} training graphs, not one")
    (step_fp, step_row), = steps.items()
    check(step_row["parameter_bytes"] == state_bytes and step_row.get("temp_bytes", 0) > 0,
          f"the training graph's ledger row {step_row}: parameters and state "
          f"{state_bytes} bytes")

    # the first loss against the port's CPU forward of the same batch
    xn = K.fused_arith(xb.to(DEVICE), ops)  # a comparison launch, after the path's count
    cpu_params = mobilenet_v2.init_params(seed=0, num_classes=CLASSES, device="cpu")
    with torch.no_grad():
        cpu_loss = float(training.softmax_cross_entropy(apply(cpu_params, xn.cpu()), yb))
    cpu_rel = abs(curve[0] - cpu_loss) / abs(cpu_loss)
    check(cpu_rel <= TRAIN_CPU_LOSS_REL, f"the first loss {curve[0]} on the card against "
                                         f"{cpu_loss} on the CPU: {cpu_rel} relative")

    # the captured steps against eager steps on the card, from the same start
    eager_params = mobilenet_v2.init_params(seed=0, num_classes=CLASSES, device=DEVICE)
    init_fn, eager_step = training.make_train_step(apply, "softmax_ce", TRAIN_OPTIMIZER,
                                                   donate=False)
    opt = init_fn(eager_params)
    start = [t.detach().clone() for t in diff_leaves(torch, eager_params)]
    eager_losses = []
    for _ in range(TRAIN_EAGER_STEPS):
        eager_params, opt, loss = eager_step(eager_params, opt, xn, yb)
        eager_losses.append(float(loss))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(curve, eager_losses))
    moved = max(float((a - s).abs().max()) for a, s in zip(diff_leaves(torch, eager_params),
                                                           start))
    apart = max(float((a.cpu() - b).abs().max())
                for a, b in zip(diff_leaves(torch, eager_params), snap["params"]))
    check(loss_rel <= TRAIN_EAGER_LOSS_REL and apart <= TRAIN_EAGER_PARAM_SHARE * moved,
          f"captured against eager over {TRAIN_EAGER_STEPS} steps: losses {curve[:3]} vs "
          f"{eager_losses} ({loss_rel} relative), params {apart} apart, moved {moved}")

    # train -> deploy: the trained parameters through slice 1's string
    desc = keep["image_labeling"][0]
    trained = mobilenet_v2.build(num_classes=CLASSES, image_size=IMAGE,
                                 params=mobilenet_v2.params_to_jax(tr.params), device=DEVICE)
    dev_params = tr._params
    deploy = {}

    def during(pl):
        be = pl["f"].backend
        src = pl["src"]
        err = 0.0
        with torch.inference_mode():
            for i in range(TRAIN_DEPLOY_FRAMES):
                x = torch.from_numpy(src._make_frame(i)).to(DEVICE)
                got = be.invoke((x,))[0]
                want = apply(dev_params, K.fused_arith(x, ops)[None])[0]
                err = max(err, float((got - want).abs().max() / want.abs().max()))
        deploy["logit_rel"] = err

    run_pipeline(nns, desc(TRAIN_DEPLOY_FRAMES), trained, TRAIN_DEPLOY_FRAMES, during=during)
    check(deploy["logit_rel"] <= TRAIN_DEPLOY_REL,
          f"the deployed filter's logits differ from eager apply of the trained parameters "
          f"by {deploy['logit_rel']} (relative)")

    # the step's rates: a trace of steady steps, the FLOPs of one step, then
    # an ungated run from the same start (its rate from the first step after
    # the capture to the card's end of the last) with the gated run's
    # lock-step pace beside it.  The ungated run comes last: a trace that
    # replays this trainer's graph while a second trainer's graph, captured
    # on another pipeline's thread, is alive segfaults in the graph launch
    # (ROADMAP C16)
    gaps = np.diff(np.asarray(arrivals[1:]))
    gated_steps_per_s = len(gaps) / float(np.sum(gaps))
    frame = Frame.of(xn, yb)
    tr.process(None, frame)
    tr_trace = trace(lambda: [tr.process(None, frame) for _ in range(TRAIN_TRACE_STEPS)])
    busy = tr_trace["busy_ms"] / TRAIN_TRACE_STEPS
    # FlopCounterMode over a step counts a depthwise conv's backward as (1 +
    # channels) forwards (its weight gradient taken for a dense conv): the
    # step's FLOPs are 3 forwards (a conv's or a GEMM's input and weight
    # gradients each cost its forward), the forward counted by FlopCounterMode
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        apply(eager_params, xn)
    flops = 3.0 * counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:  # an eager step on copies of the state
        eager_step(eager_params, opt, xn, yb)
    counted = float(counter.get_total_flops())
    p2 = nns.parse_launch(train_desc())
    p2["tr"].model = TorchModel(apply=apply, name="mobilenet_v2_train", device=DEVICE,
                                params=mobilenet_v2.init_params(seed=0, num_classes=CLASSES,
                                                                device=DEVICE))
    p2["x"].data = [xb] * TRAIN_RATE_STEPS
    p2["y"].data = [yb] * TRAIN_RATE_STEPS
    free_arrivals = []
    p2["out"].connect("new-data", lambda f: free_arrivals.append(time.perf_counter()))
    p2.start()
    try:
        check(p2.wait(600), "the ungated training run did not finish")
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        p2.stop()
    check(len(free_arrivals) == TRAIN_RATE_STEPS and p2["tr"].step_count == TRAIN_RATE_STEPS,
          f"the ungated run: {len(free_arrivals)} loss frames, {TRAIN_RATE_STEPS} sent")
    steps_per_s = (TRAIN_RATE_STEPS - TRAIN_RATE_SKIP) / (end -
                                                          free_arrivals[TRAIN_RATE_SKIP - 1])
    tflops = flops / (busy / 1e3) / 1e12
    share = tflops * 1e12 / PEAK_OPS_PER_S["bfloat16"]
    res = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, optimizer=TRAIN_OPTIMIZER,
               first_loss=curve[0], last_loss=curve[-1], loss_curve=curve[::4],
               cpu_first_loss=cpu_loss, cpu_loss_rel=cpu_rel, eager_losses=eager_losses,
               captured_vs_eager_loss_rel=loss_rel, captured_vs_eager_params=apart,
               params_moved=moved, deploy_logit_rel=deploy["logit_rel"],
               memory_bytes=marks[TRAIN_STEPS][0], ledger_row=step_row,
               steps_per_s=steps_per_s, samples_per_s=steps_per_s * TRAIN_BATCH,
               rate_steps=TRAIN_RATE_STEPS - TRAIN_RATE_SKIP,
               gated_steps_per_s=gated_steps_per_s, run_wall_s=wall,
               device_busy_ms_per_step=busy,
               device_idle_share=1 - busy * steps_per_s / 1e3,
               device_records_per_step=tr_trace["activities"] / TRAIN_TRACE_STEPS,
               host_ops_per_step=host_ops(tr_trace["calls"]) / TRAIN_TRACE_STEPS,
               flops_per_step=flops, flop_counter_step=counted, tflops_on_busy=tflops,
               busy_share_of_bf16_peak=share)
    print(f"training MobileNet-v2 1.0, batch {TRAIN_BATCH}, {IMAGE}x{IMAGE}, bf16 apply: "
          f"loss {curve[0]:.4f} -> {curve[-1]:.4f} in {TRAIN_STEPS} steps; "
          f"{steps_per_s:.2f} steps/s and {steps_per_s * TRAIN_BATCH:.1f} samples/s ungated "
          f"({gated_steps_per_s:.2f} steps/s in lock step); device busy {busy:.3f} ms and "
          f"{res['device_records_per_step']:.0f} records a step, idle share "
          f"{res['device_idle_share']:.4f}; "
          f"{flops / 1e9:.1f} GFLOP a step (3 forwards; FlopCounterMode over the step counts "
          f"{counted / 1e9:.1f}), {tflops:.2f} TFLOP/s on the busy time, {share:.4f} of the "
          f"bf16 peak [{card}]", flush=True)
    print(f"  first loss {curve[0]} against the CPU's {cpu_loss} ({cpu_rel:.2e}); captured "
          f"against eager: losses {loss_rel:.2e} relative, params {apart:.3g} apart of "
          f"{moved:.3g} moved; deployed logits {deploy['logit_rel']:.2e}; memory "
          f"{marks[2][0]} bytes at step 2 and step {TRAIN_STEPS}; the step's ledger row "
          f"{step_row}", flush=True)
    return launches, res


QUERY_FRAMES = 64          # path (a)'s timed frames, after QUERY_WARMUP frames
QUERY_WARMUP = 4
QUERY_CLIENTS = 4          # path (b): concurrent client pipelines ...
QUERY_CLIENT_FRAMES = 32   # ... of this many frames each
QUERY_BATCH = 4            # QueryServer(batch=4, max_batch=4)
QUERY_WINDOW_MS = 5.0      # its batch window
QUERY_STREAMS = 8          # path (c): decode streams, one a slot of config 4d's engine
QUERY_STEPS = 8            # steps a stream after its prefill (119 + 8 < t_max)
QUERY_MIGRATE_AT = 4       # the migrated stream's steps on server A
QUERY_RATE_SHARE = 0.25    # path (d): [sched] rate, this share of path (a)'s frames/s
QUERY_BURST = 4
QUERY_OFFERED = 64         # the requests offered under the rate
QUERY_FAULT_FRAMES = 32    # the requests under each wire fault
QUERY_FAULTS = ("seed=3;socket_drop@server:every=5", "seed=3;truncate@client:every=6",
                "seed=3;corrupt@client:every=7")


def pcts(np, xs_ms):
    return float(np.percentile(xs_ms, 50)), float(np.percentile(xs_ms, 90))


def query_phase(torch, np, K, root, card, keep):
    """Serving over the NNSQ wire on the card: (a) slice 1 offloaded to a
    QueryServer on the fragment backend, against the in-process slice bit
    for bit; (b) cross-client batching on the batch-polymorphic model, each
    coalesced group against the in-process batched filter; (c) DecodeServer
    on config 4d's engine with 8 concurrent streams and a migrated session;
    (d) admission under [sched] policy=drr with a rate, and wire faults."""
    import threading

    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch import faults
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.elements import query
    from nnstreamer_tpu_torch.elements.transform import _bind_chain, _parse_arith_ops
    from nnstreamer_tpu_torch.fleet.repo import TensorRepoServer
    from nnstreamer_tpu_torch.models import mobilenet_v2, transformer
    from nnstreamer_tpu_torch.serving import ContinuousBatcher, DecodeServer
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tree = mobilenet_v2.init_tree(0, CLASSES, 1.0)  # slice 1's model (build_quantized seed 0)
    ckpt = os.path.join(work, "query_mobilenet_v2.npz")
    save_state(tree, ckpt)
    labels = os.path.join(work, "labels_1001.txt")
    with open(labels, "w", encoding="utf-8") as f:
        f.write("\n".join(f"class_{i}" for i in range(CLASSES)))
    model_props = (f"model={ckpt} custom=builder=mobilenet_v2:build_quantized,int8_head=1,"
                   f"image_size={IMAGE},num_classes={CLASSES}")
    normalize = f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas"
    fragment = f"{normalize} ! tensor_filter framework=torch name=f {model_props}"
    tail = (f"tee name=t ! tensor_decoder mode=image_labeling option1={labels} ! "
            "tensor_sink name=out collect=true t. ! tensor_sink name=lg collect=true")

    def src(n, seed=7):
        return (f"videotestsrc name=src num-buffers={n} width={IMAGE} height={IMAGE} "
                f"pattern=random seed={seed} ! tensor_converter ! ")

    def client_desc(n, port):
        return src(n) + f"tensor_query_client name=q port={port} ! " + tail

    def inproc_desc(n):
        return (src(n) + f"{normalize} ! tensor_upload name=u ! queue max-size-buffers=16 ! "
                f"tensor_filter framework=torch name=f {model_props} ! " + tail)

    row_u8 = TensorsSpec.of(TensorSpec(np.uint8, (IMAGE, IMAGE, 3)))
    res = {}

    # -- (a) slice 1 offloaded: the fragment backend behind a QueryServer -----
    K.reset_launches()
    srv = query.QueryServer(framework="fragment", model=fragment).start()
    try:
        t0 = time.perf_counter()
        warm = srv.warmup(row_u8)
        res["a_server_warmup_s"] = time.perf_counter() - t0
        run_pipeline(nns, client_desc(QUERY_WARMUP, srv.port), None, QUERY_WARMUP)
        p, arrivals, _ = run_pipeline(nns, client_desc(QUERY_FRAMES, srv.port), None,
                                      QUERY_FRAMES)
        launches = {k.__name__: k.launches for k in K.KERNELS}
        st = srv.stats()
        (be,) = srv._backends.values()
        (filt,) = be._nodes
        bstats = dict(filt.backend.stats)
    finally:
        srv.stop()
    got_lg = [f.tensor(0) for f in p["lg"].frames]
    got = p["out"].frames
    rtt = np.asarray(list(p["q"].rtt_ns)) / 1e6
    check(launches["fused_arith"] > 0 and launches["int8_matmul"] > 0,
          f"path (a): the wrappers' launches {launches}: both kernels must run on the path")
    check(bstats["captures"] == 1 and bstats["replays"] >= QUERY_FRAMES + QUERY_WARMUP,
          f"path (a): the server's filter {bstats}: one capture (the warmup), every frame "
          "a replay")
    check(len(got_lg) == QUERY_FRAMES and all(t.device.type == "cuda" for t in got_lg),
          "path (a): the client's replies are not on the card")
    ref, _, _ = run_pipeline(nns, inproc_desc(QUERY_FRAMES), None, QUERY_FRAMES)
    want_lg = [f.tensor(0) for f in ref["lg"].frames]
    check(all(torch.equal(a, b) for a, b in zip(got_lg, want_lg)),
          "path (a): the offloaded logits differ from the in-process slice's")
    check([f.meta["label_index"] for f in got] == [f.meta["label_index"] for f in ref["out"].frames],
          "path (a): the offloaded labels differ from the in-process slice's")
    res["a"] = dict(frames=QUERY_FRAMES, launches=launches, replays=bstats["replays"],
                    warmup=[c["label"] for c in warm["compiled"]], **rates(arrivals, np),
                    rtt_p50_ms=pcts(np, rtt[-QUERY_FRAMES:])[0],
                    rtt_p90_ms=pcts(np, rtt[-QUERY_FRAMES:])[1],
                    server_invoke_ms=st["invoke_s"] / st["invokes"] * 1e3,
                    reply_read_ms=st["reply_read_s"] / st["replies"] * 1e3,
                    distinct_labels=len({f.meta["label_index"] for f in got}))
    print(f"query (a): slice 1 offloaded, {QUERY_FRAMES} frames after {QUERY_WARMUP} of "
          f"warm-up: logits and labels bitwise equal to the in-process slice; wrapper "
          f"launches {launches} (the server's warmup capture), {bstats['replays']} replays "
          f"[{card}]", flush=True)
    path_a = launches

    # -- (b) cross-client batching ------------------------------------------------
    base = mobilenet_v2.build_quantized(params=tree, int8_head=True, image_size=IMAGE,
                                        device=DEVICE)
    poly = TorchModel(apply=base.apply, params=base.params, name="mobilenet_v2_poly_int8_head",
                      input_spec=TensorsSpec.of(TensorSpec(np.float32, (None, IMAGE, IMAGE, 3))),
                      output_spec=TensorsSpec.of(TensorSpec(np.float32, (None, CLASSES))),
                      device=DEVICE)
    rng = np.random.default_rng(18)
    streams = [[torch.from_numpy(rng.integers(0, 256, (1, IMAGE, IMAGE, 3), dtype=np.uint8))
                for _ in range(QUERY_CLIENT_FRAMES)] for _ in range(QUERY_CLIENTS)]
    groups, errors, outs, rtts = [], [], {}, []
    K.reset_launches()
    srv = query.QueryServer(framework="torch", model=poly, batch=QUERY_BATCH,
                            max_batch=QUERY_BATCH, batch_window_ms=QUERY_WINDOW_MS).start()
    dispatch = srv._dispatch_group

    def recording(group):
        dispatch(group)
        groups.append(([g.tensors[0] for g in group],
                       [None if g.outs is None else g.outs[0].clone() for g in group]))

    srv._dispatch_group = recording
    try:
        warm = srv.warmup(TensorsSpec.of(TensorSpec(np.float32, (IMAGE, IMAGE, 3))))

        def client(k):
            try:
                pc = nns.parse_launch(f"datasrc name=x ! {normalize} ! "
                                      f"tensor_query_client name=q port={srv.port} ! "
                                      "tensor_sink name=out collect=true")
                pc["x"].data = streams[k]
                pc.run(timeout=300)
                outs[k] = [f.tensor(0) for f in pc["out"].frames]
                rtts.extend(list(pc["q"].rtt_ns))
            except BaseException as exc:  # noqa: BLE001 - reported below
                errors.append((k, repr(exc)))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(QUERY_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in K.KERNELS}
        st = srv.stats()
    finally:
        srv.stop()
    check(not errors, f"path (b): client failures {errors}")
    check(launches["int8_matmul"] > 0, f"path (b): int8_matmul never launched: {launches}")
    check(st["batched_invokes"] < st["batched_frames"],
          f"path (b): no group coalesced: {st['batched_invokes']} invokes for "
          f"{st['batched_frames']} frames")
    # each coalesced group against the in-process batched filter on the same
    # rows in the same order (padded to the same bucket)
    check(all(o is not None for _, gouts in groups for o in gouts),
          "path (b): a group failed on the server")
    chunks = [bucket_pad(torch, torch.cat(ins, 0), QUERY_BATCH) for ins, _ in groups]
    pin = nns.parse_launch("datasrc name=x ! tensor_filter framework=torch name=f ! "
                           "tensor_sink name=out collect=true")
    pin["f"].model = poly
    pin["x"].data = [x.to(DEVICE) for x in chunks]
    pin.run(timeout=300)
    inproc = [f.tensor(0) for f in pin["out"].frames]
    bad = group_mismatches(torch, groups, inproc)
    check(bad == 0, f"path (b): {bad} of {len(groups)} coalesced groups differ from the "
                    "in-process batched filter on the same rows")
    # and each client got its own rows of its group's result
    by_row = {}
    for ins, gouts in groups:
        for x, o in zip(ins, gouts):
            by_row[x.numpy().tobytes()] = o
    ops = _bind_chain(_parse_arith_ops(NORMALIZE), np.dtype(np.uint8))
    mismatched = 0
    for k in range(QUERY_CLIENTS):
        check(len(outs[k]) == QUERY_CLIENT_FRAMES, f"path (b): client {k} got "
                                                   f"{len(outs[k])} frames")
        for x, o in zip(streams[k], outs[k]):
            key = K.fused_arith(x.to(DEVICE), ops).cpu().numpy().tobytes()
            mismatched += key not in by_row or not torch.equal(by_row[key].to(o.device), o)
    check(mismatched == 0, f"path (b): {mismatched} replies are not their group's rows")
    rtt = np.asarray(rtts) / 1e6
    res["b"] = dict(clients=QUERY_CLIENTS, frames=QUERY_CLIENTS * QUERY_CLIENT_FRAMES,
                    batched_invokes=st["batched_invokes"], batched_frames=st["batched_frames"],
                    groups=len(groups), group_sizes=sorted({len(g[0]) for g in groups}),
                    launches=launches, warmup=[c["label"] for c in warm["compiled"]],
                    frames_per_s=QUERY_CLIENTS * QUERY_CLIENT_FRAMES / wall,
                    rtt_p50_ms=pcts(np, rtt)[0], rtt_p90_ms=pcts(np, rtt)[1],
                    server_invoke_ms=st["invoke_s"] / st["invokes"] * 1e3,
                    reply_read_ms=st["reply_read_s"] / st["replies"] * 1e3)
    print(f"query (b): {QUERY_CLIENTS} clients x {QUERY_CLIENT_FRAMES} frames, batched_invokes "
          f"{st['batched_invokes']}, batched_frames {st['batched_frames']} ({len(groups)} groups "
          f"checked bitwise against the in-process batched filter) [{card}]", flush=True)
    path_b = launches

    # -- (c) DecodeServer on config 4d's engine, and a migrated session ---------
    cell = DECODE_CELL
    decode_tree = keep["decode_tree"]
    rng = np.random.default_rng(19)
    prompts = [rng.standard_normal((PREFILL_TOKENS, cell["d_in"])).astype(np.float32)
               for _ in range(QUERY_STREAMS)]
    steps = [list(rng.standard_normal((QUERY_STEPS, cell["d_in"])).astype(np.float32))
             for _ in range(QUERY_STREAMS)]
    out_spec = TensorsSpec.of(TensorSpec(np.float32, (cell["n_out"],)))
    eng = ContinuousBatcher(capacity=ENGINE_CAPACITY, params=decode_tree, device=DEVICE, **cell)
    eng.warmup_prefill()
    engb = ContinuousBatcher(capacity=ENGINE_CAPACITY, params=decode_tree, device=DEVICE, **cell)
    engb.warmup_prefill()
    served, errors, rtts = {}, [], []
    with eng, engb:
        sa = DecodeServer(eng).start()
        sb = DecodeServer(engb).start()
        repo = TensorRepoServer().start()
        try:
            def stream(k):
                try:
                    cli = query.TensorQueryClient(port=sa.port, stateful=True, out_spec=out_spec,
                                                  name=f"decode{k}")
                    cli.start()
                    ys = [cli.process(None, Frame.of(torch.from_numpy(prompts[k]), pts=0))]
                    for i, x in enumerate(steps[k]):
                        ys.append(cli.process(None, Frame.of(torch.from_numpy(x), pts=i + 1)))
                    cli.stop()
                    served[k] = [y.tensor(0).cpu().numpy() for y in ys]
                    rtts.extend(list(cli.rtt_ns))
                except BaseException as exc:  # noqa: BLE001 - reported below
                    errors.append((k, repr(exc)))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=stream, args=(k,)) for k in range(QUERY_STREAMS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            check(not errors, f"path (c): stream failures {errors}")
            ticks = eng.stats()
            alone = {k: served_alone(eng, 0, steps[k], prompt=prompts[k])
                     for k in range(QUERY_STREAMS)}
            err = max(float(np.abs(a - b).max() / np.abs(b).max())
                      for k in range(QUERY_STREAMS) for a, b in zip(served[k], alone[k]))
            check(err <= DECODE_REL, f"path (c): a wire stream is {err} of the largest from the "
                                     f"engine's (tolerance {DECODE_REL})")
            # migrate one session: MIGRATE on A, RESUME on B, through the repo
            ctl = query.pack_session_control(f"127.0.0.1:{repo.port}", 7, 30000)
            ca = socket_pair_client(sa.port)
            mig = [query_request(query, ca, (prompts[0],), 0)]
            for i, x in enumerate(steps[0][:QUERY_MIGRATE_AT]):
                mig.append(query_request(query, ca, (x,), i + 1))
            ack = query_request(query, ca, ctl, query.MIGRATE_PTS)
            ca.close()
            cb = socket_pair_client(sb.port)
            ack_b = query_request(query, cb, ctl, query.RESUME_PTS)
            for i, x in enumerate(steps[0][QUERY_MIGRATE_AT:]):
                mig.append(query_request(query, cb, (x,), QUERY_MIGRATE_AT + i + 1))
            cb.close()
            check(int(ack[0]) == 1 and int(ack_b[0]) == 1, "path (c): the migration was refused")
            mig_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                          for a, b in zip(mig, alone[0]))
            check(mig_err <= DECODE_REL, f"path (c): the migrated session is {mig_err} of the "
                                         f"largest from an unmigrated run ({DECODE_REL})")
            mstats = (sa.stats(), sb.stats())
        finally:
            sa.stop()
            sb.stop()
            repo.stop()
    rtt = np.asarray(rtts) / 1e6
    res["c"] = dict(streams=QUERY_STREAMS, prefill_tokens=PREFILL_TOKENS, steps=QUERY_STEPS,
                    rel_err=err, migrated_rel_err=mig_err,
                    sessions_migrated=mstats[0]["sessions_migrated"],
                    sessions_restored=mstats[1]["sessions_restored"],
                    requests_per_s=QUERY_STREAMS * (QUERY_STEPS + 1) / wall,
                    rtt_p50_ms=pcts(np, rtt)[0], rtt_p90_ms=pcts(np, rtt)[1],
                    engine_ticks=ticks["ticks"], engine_steps=ticks["steps_total"])
    print(f"query (c): {QUERY_STREAMS} decode streams over the wire (prefill {PREFILL_TOKENS} "
          f"tokens, then {QUERY_STEPS} steps) within {err:.3g} of the engine's; a session "
          f"migrated A -> B after {QUERY_MIGRATE_AT} steps within {mig_err:.3g} of an "
          f"unmigrated run [{card}]", flush=True)

    # -- (d) admission under [sched] policy=drr, and faults on the wire ---------
    # One server and one capture for the admitted, the fault-free and the
    # faulted runs, so that "bit for bit" compares replays of one graph.
    frames = [torch.from_numpy(np.asarray(f)) for f in videotestsrc_frames(nns, QUERY_OFFERED)]
    # a request's admission cost is its leading dim (the JAX package's rule):
    # IMAGE for a (IMAGE, IMAGE, 3) frame, so the bucket counts in rows
    rate = max(1.0, round(QUERY_RATE_SHARE * res["a"]["fps"]))
    env = {"NNSTPU_SCHED_POLICY": "drr", "NNSTPU_SCHED_RATE": str(rate * IMAGE),
           "NNSTPU_SCHED_BURST": str(QUERY_BURST * IMAGE)}
    os.environ.update(env)
    try:
        srv = query.QueryServer(framework="fragment", model=fragment).start()
    finally:
        for key in env:
            del os.environ[key]
    sch = srv.scheduler
    res["d_faults"] = {}
    delivered, shed, other = {}, 0, []
    out_spec = TensorsSpec.of(TensorSpec(np.float32, (CLASSES,)))

    def offer(name, xs, retries=0):
        cli = query.TensorQueryClient(port=srv.port, retries=retries, retry_backoff_ms=1,
                                      out_spec=out_spec, name=name)
        cli.start()
        got, typed, untyped = {}, [], []
        for i, x in enumerate(xs):
            try:
                got[i] = cli.process(None, Frame.of(x, pts=i)).tensor(0).cpu()
            except (query.QueryError, ConnectionError) as exc:
                typed.append(exc)
            except Exception as exc:  # noqa: BLE001 - reported by the checks
                untyped.append(repr(exc))
        cli.stop()
        return got, typed, untyped, cli

    try:
        srv.warmup(row_u8)
        check(sch is not None and sch.policy.name == "drr",
              "path (d): [sched] policy=drr was not picked up")
        t0 = time.perf_counter()
        delivered, typed, other, _ = offer("admitted", frames)
        admit_wall = time.perf_counter() - t0
        shed = sum(isinstance(e, query.QueryOverloadError) for e in typed)
        other += [repr(e) for e in typed if not isinstance(e, query.QueryOverloadError)]
        adm = sch.stats()["admission"]
        srv.scheduler = None  # the fault-free and the faulted runs: no admission
        clean, typed, untyped, _ = offer("clean", frames)
        check(len(clean) == QUERY_OFFERED and not typed and not untyped,
              f"path (d): the fault-free run failed: {typed[:3]} {untyped[:3]}")
        admission_check(QUERY_OFFERED, len(delivered), shed, adm["shed_rate"], other,
                        sum(not torch.equal(v, clean[i]) for i, v in delivered.items()))
        res["d_admission"] = dict(offered=QUERY_OFFERED, delivered=len(delivered), shed=shed,
                                  rate=rate, burst=QUERY_BURST,
                                  offered_per_s=QUERY_OFFERED / admit_wall,
                                  clean_equals_path_a=all(
                                      torch.equal(clean[i], got_lg[i].cpu())
                                      for i in range(QUERY_OFFERED)))
        print(f"query (d): [sched] policy=drr rate={rate}/s burst {QUERY_BURST}: offered "
              f"{QUERY_OFFERED}, delivered {len(delivered)} (bitwise the fault-free run's), "
              f"shed {shed}, each a typed QueryOverloadError [{card}]", flush=True)
        for spec in QUERY_FAULTS:
            eng_f = faults.install(spec)
            try:
                outs_f, typed, untyped, cli = offer("faulted", frames[:QUERY_FAULT_FRAMES],
                                                    retries=3)
            finally:
                injected = sum(eng_f.injections.values())
                faults.deactivate()
            differ = sum(not torch.equal(v, clean[i]) for i, v in outs_f.items())
            wire_fault_check(spec, injected, differ, untyped)
            res["d_faults"][spec] = dict(injected=injected, retries=cli.retries_total,
                                         delivered=len(outs_f), failed_typed=len(typed),
                                         differ=differ)
            print(f"query (d) {spec}: {injected} injected, {cli.retries_total} retries, "
                  f"{len(outs_f)} delivered ({differ} unlike the fault-free run), "
                  f"{len(typed)} failed typed [{card}]", flush=True)
    finally:
        faults.deactivate()
        srv.scheduler = sch  # the conf-made scheduler closes with its server
        srv.stop()
    for name, r in (("a", res["a"]), ("b", res["b"]), ("c", res["c"])):
        for key in ("fps", "frames_per_s", "requests_per_s", "p50_ms", "p90_ms", "rtt_p50_ms",
                    "rtt_p90_ms", "server_invoke_ms", "reply_read_ms"):
            if key in r:
                print(f"  query ({name}) {key}: {r[key]} [{card}]", flush=True)
    return {k: path_a[k] + path_b[k] for k in path_a}, res


def bucket_pad(torch, x, max_batch):
    """Rows padded to their power-of-two bucket by repeating the last one,
    as the QueryServer dispatches a coalesced group."""
    n, b = x.shape[0], 1
    while b < n:
        b <<= 1
    b = min(b, max_batch)
    return torch.cat([x, x[-1:].expand(b - n, *x.shape[1:])], 0) if b > n else x


def group_mismatches(torch, groups, inproc):
    """Path (b): coalesced groups whose rows, as the server split them to
    the clients, differ from the in-process batched filter's rows for the
    same chunk (or that have no in-process chunk)."""
    bad = max(0, len(groups) - len(inproc))
    for (ins, outs), want in zip(groups, inproc):
        got = torch.cat([o.to(want.device) for o in outs], 0)
        bad += not torch.equal(got, want[:got.shape[0]])
    return bad


def admission_check(offered, delivered, shed, server_shed, untyped, differ):
    """Path (d) under a rate: every offered request delivered or shed with
    a typed QueryOverloadError, some of each, the server's count of shed
    requests the client's, and every delivered frame the fault-free one."""
    check(not untyped, f"path (d): untyped failures under admission: {untyped[:3]}")
    check(delivered + shed == offered and shed > 0 and delivered > 0,
          f"path (d): delivered {delivered} + shed {shed} != offered {offered}, or none of "
          "one kind")
    check(server_shed == shed, f"path (d): the server counted {server_shed} shed, the client "
                               f"{shed}")
    check(differ == 0, f"path (d): {differ} admitted frames differ from the fault-free run")


def wire_fault_check(spec, injected, differ, untyped):
    """Path (d) under a wire fault: it fired, nothing failed untyped, and the
    delivered frames are the fault-free run's bit for bit; under ``corrupt``
    at most the injected frames differ: NNSQ carries no checksum (nor does
    the JAX package's wire), so a flipped payload byte reaches the model as
    data."""
    check(not untyped and injected > 0, f"path (d) {spec}: {injected} injections, untyped "
                                        f"failures {untyped[:3]}")
    if "corrupt@" in spec:
        check(differ <= injected, f"path (d) {spec}: {differ} frames differ from the "
                                  f"fault-free run, {injected} injected")
    else:
        check(differ == 0, f"path (d) {spec}: {differ} delivered frames differ from the "
                           "fault-free run")


def socket_pair_client(port):
    import socket

    return socket.create_connection(("127.0.0.1", port), timeout=120)


def query_request(query, sock, tensors, pts):
    query.send_tensors(sock, tensors, pts)
    outs, _ = query.recv_tensors(sock)
    return outs[0]


def videotestsrc_frames(nns, n, seed=7):
    """The first ``n`` frames of slice 1's source, as the converter gives them."""
    p = nns.parse_launch(f"videotestsrc num-buffers={n} width={IMAGE} height={IMAGE} "
                         f"pattern=random seed={seed} ! tensor_converter ! "
                         "tensor_sink name=out collect=true")
    p.run(timeout=120)
    return [f.tensor(0) for f in p["out"].frames]


C16_STEPS = 4     # steps of each trainer before its pipeline stops
C16_REPLAYS = 4   # replays of trainer A inside the window


def c16_phase(torch, np, K, ops, card):
    """ROADMAP C16's order at train_phase's size: trainer A's graph captured
    in one pipeline, trainer B's in a second, both pipelines stopped, then a
    torch.profiler window (the lane's capture lock held) that replays A.
    It ends in a trace or in the typed error that names C16, never in a
    dead process; then A replays outside the window and B inside one."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.obs import profiler

    def apply(p, x):
        return mobilenet_v2.apply(p, x, dtype=torch.bfloat16)

    rng = np.random.default_rng(TRAIN_SEED)
    xb = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8))
    yb = torch.from_numpy(rng.integers(0, CLASSES, TRAIN_BATCH).astype(np.int32))

    def trainer(name):
        p = nns.parse_launch(train_desc())
        p["tr"].model = TorchModel(apply=apply, name=name, device=DEVICE,
                                   params=mobilenet_v2.init_params(seed=0, num_classes=CLASSES,
                                                                   device=DEVICE))
        p["x"].data = [xb] * C16_STEPS
        p["y"].data = [yb] * C16_STEPS
        p.start()
        try:
            check(p.wait(600), f"C16: trainer {name} did not finish")
        finally:
            p.stop()
        check(p["tr"].step_count == C16_STEPS, f"C16: trainer {name} took "
                                               f"{p['tr'].step_count} steps")
        return p

    pa = trainer("c16_a")
    pb = trainer("c16_b")
    tr_a, tr_b = pa["tr"], pb["tr"]
    frame = Frame.of(K.fused_arith(xb.to(DEVICE), ops), yb)
    res = {}
    try:
        tr_trace = trace(lambda: [tr_a.process(None, frame) for _ in range(C16_REPLAYS)])
        res.update(outcome="trace", device_records=tr_trace["activities"])
    except profiler.ProfiledReplayHazard as exc:
        res.update(outcome="typed error", error=str(exc)[:200])
    check(tr_a.step_count == C16_STEPS + (C16_REPLAYS if res["outcome"] == "trace" else 0),
          f"C16: trainer A took {tr_a.step_count} steps")
    before = tr_a.step_count
    losses = [float(tr_a.process(None, frame).tensor(0)) for _ in range(2)]
    check(tr_a.step_count == before + 2 and all(np.isfinite(losses)),
          f"C16: A's replays outside the window: {losses}")
    b_trace = trace(lambda: [tr_b.process(None, frame) for _ in range(C16_REPLAYS)])
    check(b_trace["activities"] > 0, "C16: the window over B's replays holds no device record")
    res.update(a_losses_after=losses, b_window_device_records=b_trace["activities"])
    print(f"C16: trainer A and B captured on two pipelines' threads, both stopped; a profiler "
          f"window replaying A ended in a {res['outcome']}"
          + (f" ({res['error']})" if "error" in res else
             f" ({res['device_records']} device records)")
          + f"; A replays outside it, a window over B holds {b_trace['activities']} device "
          f"records [{card}]", flush=True)
    del pa, pb
    return {k.__name__: 0 for k in K.KERNELS}, res


STREAM_FRAMES = 68          # the capture: slice 1's frames, 30/1 timestamps
STREAM_RATE = "20/1"        # tensor_rate's output rate: drops and duplicates on the 30/1 stamps
SPARSE_MASKS = 64           # (d): seeded class masks, a segmentation model's output
SPARSE_SIZE = 512
SPARSE_CLASSES = 21
SPARSE_DENSITY = 0.04       # about this share non-zero
IIO_SCANS = 32              # (e): continuous-mode scans through a FIFO
DIRECT_FRAMES = 4


def gate_model(maxima, threshold):
    """tensor_if compared-value=max op=> threshold=T: which frames pass."""
    return [m > threshold for m in maxima]


def rate_model(stamps, period):
    """What tensor_rate sends for frames stamped ``(pts, duration)`` at a
    ``period`` (ns): a list of (output slot, input index), and the drops and
    duplicates.  A frame takes the slot nearest its pts; a frame whose slot
    is taken is dropped; the slots skipped before a frame repeat the frame
    received last (dropped or not); at the end the slots whose centers lie
    before the last frame's end repeat it."""
    out, drop, nxt, last, end = [], 0, 0, None, None
    for i, (pts, dur) in enumerate(stamps):
        end = pts + dur
        slot = (pts + period // 2) // period
        if slot < nxt:
            drop += 1
        else:
            if last is not None:
                out.extend((s, last) for s in range(nxt, slot))
            out.append((slot, i))
            nxt = slot + 1
        last = i
    if last is not None:
        while nxt * period + period // 2 < end:
            out.append((nxt, last))
            nxt += 1
    return out, drop, len(out) - (len(stamps) - drop)


def stream_counts_check(got, want, what):
    """The gate's and the rate's counters against the host model's."""
    check(got == want, f"{what}: counters {got}, the host model of the logits and "
                       f"timestamps gives {want}")


def checksum_check(sums, byte_sums, what):
    """A tap's checksums against the byte sums of the frames it should see."""
    check(len(sums) == len(byte_sums), f"{what}: {len(sums)} checksums for "
                                       f"{len(byte_sums)} frames")
    bad = [i for i, (a, b) in enumerate(zip(sums, byte_sums)) if a != b]
    check(not bad, f"{what}: checksums differ from the frames' byte sums at {bad[:8]}")


def class_masks(np, rng, n, size, classes, density):
    """``n`` (size, size) uint8 masks: rectangles of random classes over a
    zero background, about ``density`` of the pixels non-zero."""
    masks = []
    for _ in range(n):
        m = np.zeros((size, size), np.uint8)
        while np.count_nonzero(m) < density * size * size:
            h, w = rng.integers(size // 32, size // 8, 2)
            y, x = rng.integers(0, size - h), rng.integers(0, size - w)
            m[y:y + h, x:x + w] = rng.integers(1, classes)
        masks.append(m)
    return masks


def pb_messages(data):
    """(start, end) of each message of a length-prefixed protobuf capture."""
    spans, off = [], 0
    while off < len(data):
        size = int.from_bytes(data[off:off + 8], "little")
        spans.append((off + 8, off + 8 + size))
        off += 8 + size
    return spans


def byte_sum(torch, t):
    return int(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).to(torch.int64).sum())


def stream_phase(torch, np, K, root, card, keep):
    """Stream capture, replay and flow control on slice 1 at full width: (a)
    capture to a protobuf file and an NNSTPU1 file; (b) the protobuf replay
    through slice 1's kernels, taps, tensor_if and tensor_rate, held bit for
    bit to the in-process slice and to a host model of its counts; (c) the
    same from tensor_load; (d) the sparse pair on host and card masks; (e)
    direct_video on card frames and tensor_src_iio over a FIFO."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.interop import decode_frame
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

    work = os.path.join(root, "build", "chip_smoke", "stream")
    os.makedirs(work, exist_ok=True)
    pb, nns_file = os.path.join(work, "cap.pb"), os.path.join(work, "cap.nns")
    labels = os.path.join(root, "build", "chip_smoke", "labels_1001.txt")
    model = keep["image_labeling"][1]
    kernels = ("fused_arith", "int8_matmul")
    n = STREAM_FRAMES
    res = {}

    # -- (a) capture --------------------------------------------------------------
    src = (f"videotestsrc num-buffers={n} width={IMAGE} height={IMAGE} pattern=random seed=7 ! "
           "tensor_converter")
    cap = nns.parse_launch(
        src + f" ! tee name=t t. ! queue ! tensor_decoder mode=protobuf ! filesink name=pb location={pb} "
        # a source's frames carry its VideoSpec in meta, which tensor_save
        # refuses (as the JAX package's does): tensor_demux makes new frames
        f"t. ! queue ! tensor_demux ! tensor_save name=save location={nns_file} "
        "t. ! queue ! tensor_sink name=orig collect=true")
    t0 = time.perf_counter()
    cap.run(timeout=300)
    res["capture_host_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n
    orig = [f.tensor(0) for f in cap["orig"].frames]
    check(len(orig) == n and cap["pb"].num_frames == n and cap["save"].num_frames == n,
          f"capture: {len(orig)} frames, {cap['pb'].num_frames} messages, "
          f"{cap['save'].num_frames} saved of {n}")
    stamps = [(f.pts, f.duration) for f in cap["orig"].frames]
    with open(pb, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    spans = pb_messages(data)
    parsed = [decode_frame(memoryview(data)[a:b]) for a, b in spans]
    res["parse_host_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n
    check(len(parsed) == n and all(torch.equal(a.tensor(0), b) for a, b in zip(parsed, orig)),
          "capture: the protobuf file does not hold the source's frames")
    res.update(pb_bytes=os.path.getsize(pb), nns_bytes=os.path.getsize(nns_file))
    with open(os.path.join(work, "cap16.pb"), "wb") as f:
        f.write(data[:spans[PROFILED - 1][1]])
    orig_sums = [byte_sum(torch, t) for t in orig]

    # -- slice 1 in process: the logits the replays are held to --------------------
    normalize = f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas"
    ref, _, _ = run_pipeline(
        nns, src + f" ! {normalize} ! tensor_upload ! "
        "queue max-size-buffers=16 ! tensor_filter framework=torch name=f ! tee name=lt "
        f"lt. ! queue ! tensor_sink name=lg collect=true lt. ! tensor_decoder "
        f"mode=image_labeling option1={labels} ! tensor_sink name=out collect=true", model, n)
    want_lg = [f.tensor(0) for f in ref["lg"].frames]
    want_idx = [f.meta["label_index"] for f in ref["out"].frames]
    maxima = sorted(float(t.max()) for t in want_lg)
    threshold = (maxima[n // 2 - 1] + maxima[n // 2]) / 2  # about half pass
    passed = gate_model([float(t.max()) for t in want_lg], threshold)
    kept = [i for i in range(n) if passed[i]]
    period = int(1e9 * int(STREAM_RATE.split("/")[1]) / int(STREAM_RATE.split("/")[0]))
    slots, drop, dup = rate_model([stamps[i] for i in kept], period)
    want_gate = (len(kept), n - len(kept))
    want_out = [(s * period, want_idx[kept[j]]) for s, j in slots]
    check(drop > 0 and dup > 0, f"the rate's host model neither drops nor duplicates: {drop}, "
                                f"{dup}: pick another rate")

    def replay_desc(head):
        return (f"{head} ! tensor_debug name=tap0 checksum=true capacity=128 ! {normalize} ! "
                "tensor_upload name=u ! queue max-size-buffers=16 ! tensor_filter framework=torch "
                "name=f ! tensor_debug name=tap1 checksum=true capacity=128 ! tensor_if name=gate "
                f"compared-value=max op=> threshold={threshold!r} ! tensor_rate name=rate "
                f"framerate={STREAM_RATE} ! tensor_decoder mode=image_labeling option1={labels} ! "
                "tensor_sink name=out collect=true")

    def recording(p, seen, times):
        tap = p["tap1"]
        process = tap.process

        def record(pad, frame):
            times.append(time.perf_counter())
            seen.append(frame.tensor(0).clone())
            return process(pad, frame)

        tap.process = record

    def replay(head, what):
        seen, times = [], []
        K.reset_launches()
        p = nns.parse_launch(replay_desc(head))
        p["f"].model = model
        recording(p, seen, times)
        p.start()
        try:
            check(p.wait(600), f"{what}: the replay did not finish")
        finally:
            p.stop()
        launches = {k.__name__: k.launches for k in K.KERNELS}
        stats = dict(p["f"].backend.stats)
        check(stats["captures"] == 1 and stats["replays"] == n,
              f"{what}: expected one capture and {n} replays: {stats}")
        check(all(launches[k] > 0 for k in kernels), f"{what}: wrapper launches {launches}")
        check(len(seen) == n and all(torch.equal(a, b) for a, b in zip(seen, want_lg)),
              f"{what}: the logits at the filter's tap differ from the in-process slice's")
        stream_counts_check((p["gate"].passed, p["gate"].dropped), want_gate, f"{what} gate")
        rate = p["rate"]
        stream_counts_check((rate.in_frames, rate.out_frames, rate.drop, rate.dup),
                            (len(kept), len(slots), drop, dup), f"{what} rate")
        out = [(f.pts, f.meta["label_index"]) for f in p["out"].frames]
        check(out == want_out, f"{what}: the sink's (pts, label) differ from the host model's")
        checksum_check([r["checksum"][0] for r in p["tap0"].stats()["last"]], orig_sums,
                       f"{what} tap0")
        checksum_check([r["checksum"][0] for r in p["tap1"].stats()["last"]],
                       [byte_sum(torch, t) for t in want_lg], f"{what} tap1")
        return p, launches, stats, rates(times, np), seen

    def traced(head):
        def run(k):
            p = nns.parse_launch(replay_desc(head))
            p["f"].model = model
            gate = p["u"]._lock
            gate.acquire()
            try:
                p.start()
                # the capture before the window: a self-describing stream's
                # filter would capture at its first frame
                p["f"].warm_spec(TensorsSpec.of(TensorSpec(np.uint8, (IMAGE, IMAGE, 3))))
            except BaseException:
                gate.release()
                p.stop()
                raise
            try:
                tr = trace(lambda: (time.sleep(0.25), gate.release(),
                                    check(p.wait(600), "traced replay did not finish")))
            finally:
                p.stop()
            check(p["tap1"].frames == k, f"traced replay: {p['tap1'].frames} of {k} frames")
            return tr
        return run

    # -- (b) the protobuf replay -----------------------------------------------------
    head_b = f"filesrc location={pb} ! tensor_converter input-format=protobuf"
    pb_run, launches_b, stats_b, rate_b, seen_b = replay(head_b, "replay (b)")
    res["b"] = dict(frames=n, replays=stats_b["replays"], launches=launches_b, **rate_b,
                    passed=want_gate[0], dropped=want_gate[1], rate_out=len(slots),
                    rate_drop=drop, rate_dup=dup, threshold=threshold)
    profile_path(traced(f"filesrc location={os.path.join(work, 'cap16.pb')} ! "
                        "tensor_converter input-format=protobuf"), res["b"], kernels)
    # -- (c) the same path from tensor_load --------------------------------------------
    head_c = f"tensor_load location={nns_file}"
    ld_run, launches_c, stats_c, rate_c, seen_c = replay(head_c, "replay (c)")
    check(all(torch.equal(a, b) for a, b in zip(seen_c, seen_b)),
          "replay (c): the logits differ from replay (b)'s")
    check([(f.pts, f.meta["label_index"]) for f in ld_run["out"].frames]
          == [(f.pts, f.meta["label_index"]) for f in pb_run["out"].frames],
          "replay (c): the sink's frames differ from replay (b)'s")
    res["c"] = dict(frames=n, replays=stats_c["replays"], launches=launches_c, **rate_c)
    profile_path(traced(f"tensor_load location={nns_file} num-buffers={PROFILED}"),
                 res["c"], kernels)
    for key, what in (("b", "protobuf replay (b)"), ("c", "tensor_load replay (c)")):
        r = res[key]
        print(f"stream {what}: {n} frames, one capture, {r['replays']} replays, logits bit for "
              f"bit the in-process slice's; gate {want_gate[0]} passed / {want_gate[1]} dropped, "
              f"rate {STREAM_RATE} {len(slots)} out / {drop} dropped / {dup} duplicated (the "
              f"host model's); {r['fps']:.2f} fps, p50 gap {r['p50_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms_per_frame']:.4f} ms/frame, records "
              f"{r['kernel_records']} [{card}]", flush=True)
    print(f"stream capture: {res['pb_bytes']} bytes of protobuf, {res['nns_bytes']} bytes of "
          f"NNSTPU1 for {n} frames; capture {res['capture_host_ms_per_frame']:.3f} ms/frame, "
          f"parse {res['parse_host_ms_per_frame']:.3f} ms/frame (host) [{card}]", flush=True)

    # -- (d) the sparse pair ---------------------------------------------------------------
    masks = [torch.from_numpy(m) for m in class_masks(
        np, np.random.default_rng(19), SPARSE_MASKS, SPARSE_SIZE, SPARSE_CLASSES,
        SPARSE_DENSITY)]
    res["d"] = dict(masks=SPARSE_MASKS, density=float(np.mean([float((m != 0).float().mean())
                                                               for m in masks])))
    for where, upload in (("host", ""), ("card", "tensor_upload ! queue ! ")):
        for _ in range(2):  # the second run is timed: the first loads the kernels it uses
            p = nns.parse_launch(f"datasrc name=s ! {upload}tensor_sparse_enc name=enc ! "
                                 "queue ! tensor_sparse_dec ! tensor_sink name=out collect=true")
            p["s"].data = masks
            t0 = time.perf_counter()
            p.run(timeout=300)
            wall = time.perf_counter() - t0
            outs = [f.tensor(0) for f in p["out"].frames]
            device = "cuda" if upload else "cpu"
            check(len(outs) == SPARSE_MASKS and all(o.device.type == device for o in outs),
                  f"sparse ({where}): {len(outs)} masks, devices "
                  f"{sorted({o.device.type for o in outs})}")
            check(all(torch.equal(o.cpu(), m) for o, m in zip(outs, masks)),
                  f"sparse ({where}): a mask does not round-trip bit for bit")
        enc = p["enc"]
        res["d"][where] = dict(bytes_in=enc.bytes_in, bytes_out=enc.bytes_out,
                               ratio=enc.bytes_out / enc.bytes_in,
                               ms_per_mask=wall * 1e3 / SPARSE_MASKS)
        print(f"stream sparse ({where}): {SPARSE_MASKS} {SPARSE_SIZE}x{SPARSE_SIZE} uint8 masks "
              f"({res['d']['density']:.4f} non-zero) round-trip bit for bit; bytes out / in "
              f"{enc.bytes_out} / {enc.bytes_in} = {enc.bytes_out / enc.bytes_in:.4f}, "
              f"{wall * 1e3 / SPARSE_MASKS:.3f} ms/mask [{card}]", flush=True)

    # -- (e) direct_video on card frames, tensor_src_iio over a FIFO ---------------------
    p = nns.parse_launch(f"videotestsrc num-buffers={DIRECT_FRAMES} width={IMAGE} "
                         f"height={IMAGE} pattern=random seed=7 ! tensor_converter ! "
                         "tensor_upload ! queue ! tensor_decoder mode=direct_video ! "
                         "tensor_sink name=out collect=true")
    p.run(timeout=120)
    vids = p["out"].frames
    check(len(vids) == DIRECT_FRAMES and all(
        f.tensor(0).device.type == "cuda" and torch.equal(f.tensor(0).cpu(), o)
        and (f.meta["media"].format, f.meta["media"].width, f.meta["media"].height)
        == ("RGB", IMAGE, IMAGE) for f, o in zip(vids, orig)),
        "direct_video: the card frames or their VideoSpec are wrong")
    res["e"] = dict(direct_video_frames=len(vids), iio=iio_run(np, torch, nns, work))
    print(f"stream (e): direct_video on {len(vids)} card frames (RGB {IMAGE}x{IMAGE}), "
          f"tensor_src_iio continuous over a FIFO: {res['e']['iio']} [{card}]", flush=True)
    launches = {k: launches_b[k] + launches_c[k] for k in launches_b}
    return launches, res


def iio_run(np, torch, nns, work):
    """tensor_src_iio in continuous mode over a fake sysfs tree and a FIFO
    fed by a thread: IIO_SCANS scans of two 12-bit channels and a 64-bit
    timestamp, each value against its independent decode."""
    import shutil
    import struct
    import threading

    base = os.path.join(work, "iio", "devices")
    devs = os.path.join(work, "iio", "dev")
    shutil.rmtree(os.path.join(work, "iio"), ignore_errors=True)
    dev = os.path.join(base, "iio:device0")
    os.makedirs(os.path.join(dev, "scan_elements"))
    os.makedirs(os.path.join(dev, "buffer"))
    os.makedirs(os.path.join(dev, "trigger"))
    os.makedirs(os.path.join(base, "trigger0"))
    os.makedirs(devs)

    def put(path, text):
        with open(os.path.join(base, path), "w") as f:
            f.write(text + "\n")

    put("iio:device0/name", "fake_imu")
    put("trigger0/name", "hrtimer0")
    for path in ("buffer/length", "buffer/enable", "sampling_frequency"):
        put(f"iio:device0/{path}", "0")
    put("iio:device0/trigger/current_trigger", "")
    put("iio:device0/sampling_frequency_available", "100 200")
    for i, (ch, typ) in enumerate((("accel_x", "le:s12/16>>4"), ("accel_y", "be:s12/16>>4"),
                                   ("timestamp", "le:s64/64"))):
        put(f"iio:device0/scan_elements/in_{ch}_en", "0")
        put(f"iio:device0/scan_elements/in_{ch}_index", str(i))
        put(f"iio:device0/scan_elements/in_{ch}_type", typ)
    put("iio:device0/in_accel_x_scale", "0.5")
    put("iio:device0/in_accel_y_offset", "8")
    rng = np.random.default_rng(23)
    raw = rng.integers(-2048, 2048, (IIO_SCANS, 2))
    want = [[x * 0.5, float(y + 8), float(k)] for k, (x, y) in enumerate(raw)]
    fifo = os.path.join(devs, "iio:device0")
    os.mkfifo(fifo)

    def writer():
        with open(fifo, "wb") as f:
            for k, (x, y) in enumerate(raw):
                f.write(struct.pack("<h", int(x) << 4) + struct.pack(">h", int(y) << 4)
                        + b"\0" * 4 + struct.pack("<q", k))
                f.flush()

    thread = threading.Thread(target=writer, daemon=True)
    thread.start()
    p = nns.parse_launch(f"tensor_src_iio mode=continuous device=fake_imu trigger=hrtimer0 "
                         f"frequency=100 buffer-capacity=8 num-buffers={IIO_SCANS} "
                         f"poll-timeout=10000 base-dir={base} dev-dir={devs} ! tensor_upload ! "
                         "queue ! tensor_sink name=out collect=true")
    p.run(timeout=120)
    thread.join(timeout=30)
    got = [f.tensor(0) for f in p["out"].frames]
    check(len(got) == IIO_SCANS and all(t.device.type == "cuda" for t in got),
          f"tensor_src_iio: {len(got)} of {IIO_SCANS} scans reached the card")
    check(all(t.cpu().tolist() == w for t, w in zip(got, want)),
          "tensor_src_iio: a scan's decoded values differ from the independent decode")
    with open(os.path.join(dev, "trigger", "current_trigger")) as f:
        trig = f.read().strip()
    check(trig == "hrtimer0", f"tensor_src_iio: current_trigger {trig!r}")
    return dict(scans=len(got), pts_ns=[f.pts for f in p["out"].frames][:3])


# -- phase 30: the mesh (in-model parallel modes, the dispatch mesh) ---------

PAR_SHARDS = 4             # force_device_count(4): four shards on the one card
PAR_FRAMES = 64            # (a): frames a mode through slice 1's string
PAR_REF_FRAMES = 4         # frames held against attn="full" and against eager calls
# one trace a path: CUPTI loses the first launch's records this late in the
# script, which launch_check allows, and each retry costs a capture
PAR_TRACES = 1
# (a) ring and Ulysses against attn="full" in bfloat16: the ring accumulates
# in float32 where full attention rounds its softmax in bfloat16, through 12
# layers
PAR_VIT_REL = 1 / 16
# (b) Switch-Base (Fedus et al. 2021): d_model 768, 12 heads, d_ff 3072, 8
# experts, 12 layers; the encoder alone, fed (T, d_in) windows, the MoE in
# every block; top-1 routing at capacity factor 2.0
SWITCH_BASE = dict(d_model=768, n_heads=12, n_layers=12, d_ff=3072, experts=8)
MOE_WINDOW = (512, 768)    # int16 features a window
MOE_WINDOWS = 16
MOE_OUT = 16               # the head's outputs a token
MOE_NORMALIZE = "typecast:float32,div:32768.0"
MOE_REL = 1 / 16           # ep:4 against unsharded, bfloat16 (a routing flip moves a token)
MOE_ARGMAX_SHARE = 0.99    # tokens whose argmax the two runs share, at least
# (c) GPipe at ViT-B's encoder widths, float32 (the reference's default)
PP_CFG = dict(d_model=768, n_heads=12, n_layers=12, seq_len=196, d_in=768, n_out=MOE_OUT)
PP_BATCH, PP_MICRO, PP_BATCHES = 8, 4, 8
PP_REL = 1e-4              # float32, TF32 off: microbatches of 2 against a batch of 8
# (d) config 5 at 8 streams, the int8 head, under NNSTPU_MESH=dp:4
MESH_STREAMS = 8
MESH_ROUNDS = 16
MESH_EAGER = 4             # rounds held bit for bit against the sharded eager forward
# each stream's frames: 127 plus noise of this amplitude, so that the shards'
# activation maxima differ and a per-shard scale would show
MESH_CONTRAST = (128, 128, 1, 1, 2, 2, 8, 8)


def parallel_legs():
    """The five legs of the mesh phase, for the report."""
    sb = SWITCH_BASE
    return {
        "a": f"ViT-B/16 bf16, slice 1's string, attn=ring then ulysses over sp:{PAR_SHARDS} "
             f"(196 tokens: 49 a shard; 12 heads: 3 a shard), {PAR_FRAMES} frames a mode",
        "b": f"switch-MoE encoder at Switch-Base-8 widths ({sb['d_model']}/{sb['n_heads']}/"
             f"{sb['d_ff']}, {sb['experts']} experts, {sb['n_layers']} layers; MoE in every "
             f"block, the encoder alone) over ep:{PAR_SHARDS} and unsharded, "
             f"{MOE_WINDOWS} windows of {MOE_WINDOW[0]}x{MOE_WINDOW[1]} int16, bf16",
        "c": f"GPipe at ViT-B encoder widths, {PP_CFG['n_layers']} layers in {PAR_SHARDS} "
             f"stages over pp:{PAR_SHARDS}, batch {PP_BATCH} of {PP_CFG['seq_len']}x"
             f"{PP_CFG['d_in']}, {PP_MICRO} microbatches, float32, {PP_BATCHES} batches",
        "d": f"config 5 at {MESH_STREAMS} streams, int8 head, NNSTPU_MESH=dp:{PAR_SHARDS} "
             f"({MESH_STREAMS // PAR_SHARDS} rows a shard), torch-sharded, config 1d's "
             f"buckets {PAR_SHARDS} x {{1, 2, 4, 8}}",
        "e": "one device-lane series a shard of (d)'s torch-sharded run",
    }


def shard_launch_check(tr, shards, segment_kernels):
    """A sharded dispatch's trace: a round of ``shards x segments`` graph
    launches (segment k of every shard, then segment k + 1), launch ``j`` of
    a round replaying shard ``j % shards``'s segment ``j // shards``, which
    holds one record of each kernel of ``segment_kernels[k]`` and none of
    the others.  A launch with fewer device records than the fullest launch
    of its segment lost them in the tracer and may lack as many path
    records.  Returns (rounds, each kernel's records, records lost)."""
    seg = len(segment_kernels)
    per_round = shards * seg
    n = len(tr["per_launch"])
    check(n > 0 and n % per_round == 0,
          f"{n} graph launches: not whole rounds of {shards} shards x {seg} segments")
    full = {}
    for j, (_, total) in enumerate(tr["per_launch"]):
        k = (j % per_round) // shards
        full[k] = max(full.get(k, 0), total)
    counts, lost = {}, 0
    for j, (rec, total) in enumerate(tr["per_launch"]):
        k = (j % per_round) // shards
        want = segment_kernels[k]
        extra = {w: c for w, c in rec.items() if c > (1 if w in want else 0)}
        check(not extra, f"graph launch {j} (segment {k}) holds {extra} kernel records")
        missing = [w for w in want if not rec.get(w)]
        check(len(missing) <= full[k] - total,
              f"graph launch {j} (segment {k}) holds no record of {missing}")
        lost += full[k] - total
        for w, c in rec.items():
            counts[w] = counts.get(w, 0) + c
    return n // per_round, counts, lost


def rows_check(np, got, want, rel):
    """Rows against rows: within ``rel`` of the largest ``want`` value, the
    argmax of every row equal.  Returns the largest relative difference."""
    check(len(got) == len(want) > 0, f"{len(got)} rows against {len(want)}")
    top = max(float(np.abs(w).max()) for w in want)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        d = float(np.abs(a.astype(np.float64) - b).max()) / top
        worst = max(worst, d)
        check(d <= rel, f"row {i}: {d} of the largest value apart (tolerance {rel})")
        check(int(np.argmax(a)) == int(np.argmax(b)), f"row {i}: argmax differs")
    return worst


def sharded_capture_check(stats, frames, launches, kernels, shards):
    """A sharded path: one capture (one entry of a graph a shard and
    segment), a replay a frame, each path kernel's wrapper called once a
    shard in each warm-up call and in the capture."""
    check(stats["captures"] == 1 and stats["replays"] == frames,
          f"expected one capture and {frames} replays: {stats}")
    calls = stats["warmup_calls"] + 1
    want = {k: (calls * shards if k in kernels else 0) for k in KERNEL_SYMBOLS}
    check(launches == want, f"wrapper launches {launches}, expected {want}")


def vit_mesh_leg(torch, np, K, nns, ops, card, keep, mesh, real):
    """(a): ViT-B/16 with ring, then Ulysses attention over the sp mesh."""
    import dataclasses

    from nnstreamer_tpu_torch.models import vit

    desc_of, full = keep["vit"]
    patch, dt = VIT_B16["patch"], torch.bfloat16
    out = {}
    for mode in ("ring", "ulysses"):
        model = dataclasses.replace(full, name=f"vit_{mode}_sp{PAR_SHARDS}",
                                    apply=lambda p, x, m=mode: vit.forward(p, x, patch, dt, m,
                                                                           mesh, "sp"))
        state = {}

        def during(p, model=model):
            be = p["f"].backend
            state.update(stats=dict(be.stats),
                         launches={k.__name__: k.launches for k in K.KERNELS},
                         folded=not any(type(x).__name__ == "TensorTransform"
                                        for x in p.nodes.values()))
            xs = [torch.from_numpy(p["src"]._make_frame(i)) for i in range(PAR_REF_FRAMES)]
            captured_against_eager(torch, be, xs, exact=True)
            with torch.inference_mode():
                state["logits"] = [be.invoke((x,))[0].float().cpu().numpy() for x in xs]
                state["full"] = [full(K.fused_arith(x.cuda(), ops)).float().cpu().numpy()
                                 for x in xs]
                # the real device count: a mesh of the cards there are
                one = vit.forward(full.params, K.fused_arith(xs[0].cuda(), ops), patch, dt,
                                  mode, real, "sp")
                state["real"] = one.float().cpu().numpy()

        K.reset_launches()
        _, arrivals, _ = run_pipeline(nns, desc_of(PAR_FRAMES), model, PAR_FRAMES,
                                      during=during)
        check(state["folded"], f"(a) {mode}: the normalize did not fold into the filter")
        vit_checks(state["stats"], state["launches"], PAR_FRAMES)
        worst, close = vit_cpu_check(np, state["logits"], state["full"], PAR_VIT_REL)
        top1 = sum(int(a.argmax()) == int(b.argmax())
                   for a, b in zip(state["logits"], state["full"]))
        real_rel = float(np.abs(state["real"] - state["full"][0]).max()
                         / np.abs(state["full"][0]).max())
        check(real_rel <= PAR_VIT_REL, f"(a) {mode} on {real.size} real device(s): "
                                       f"{real_rel} of the largest logit from full")
        res = dict(mode=mode, frames=PAR_FRAMES, replays=state["stats"]["replays"],
                   **rates(arrivals, np), capture_s=state["stats"]["capture_s"],
                   rel_to_full=worst, top1_equal=top1, top1_by_margin=close,
                   real_devices=real.size, real_rel_to_full=real_rel,
                   launches=state["launches"])
        profile_path(lambda n, model=model: traced_run(nns, desc_of(n), model, n), res,
                     ("fused_arith",), attempts=PAR_TRACES)
        print(f"(a) ViT-B/16 attn={mode} over sp:{PAR_SHARDS}: {PAR_FRAMES} frames, one "
              f"capture; replays bitwise equal to eager on {PAR_REF_FRAMES} frames; logits "
              f"within {worst:.3g} of attn=full (tolerance {PAR_VIT_REL}), top-1 equal on "
              f"{top1} of {PAR_REF_FRAMES} ({close} decided by the margin); on the "
              f"{real.size} real device(s) {real_rel:.3g} [{card}]", flush=True)
        report_path(f"(a) ViT-B/16 {mode}", res, card)
        out[mode] = res
    return out


def card_tree(torch, seed, d_model, n_heads, n_layers, d_ff, d_in, n_out, experts=0):
    """Random encoder params in the JAX package's layout (``transformer.
    init_tree``'s shapes and scales, ``parallel/moe.init_moe_tree``'s for an
    MoE block), drawn on the card from ``seed``: numpy would take seconds
    for Switch-Base-8's 0.48 G parameters."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=DEVICE) * std

    def dense(cin, cout):
        return {"w": normal((cin, cout), (1.0 / cin) ** 0.5), "b": torch.zeros(cout, device=DEVICE)}

    def ln():
        return {"scale": torch.ones(d_model, device=DEVICE),
                "bias": torch.zeros(d_model, device=DEVICE)}

    blocks = []
    for _ in range(n_layers):
        blk = {"ln1": ln(), "qkv": dense(d_model, 3 * d_model),
               "proj": dense(d_model, d_model), "ln2": ln()}
        if experts:
            blk["moe"] = {"gate": dense(d_model, experts),
                          "w1": normal((experts, d_model, d_ff), (2.0 / d_model) ** 0.5),
                          "b1": torch.zeros(experts, d_ff, device=DEVICE),
                          "w2": normal((experts, d_ff, d_model), (2.0 / d_ff) ** 0.5),
                          "b2": torch.zeros(experts, d_model, device=DEVICE)}
        else:
            blk["ff1"], blk["ff2"] = dense(d_model, d_ff), dense(d_ff, d_model)
        blocks.append(blk)
    return {"embed": dense(d_in, d_model), "blocks": blocks, "ln_f": ln(),
            "head": dense(d_model, n_out), "n_heads": n_heads}


def moe_mesh_leg(torch, np, K, nns, card, mesh, real):
    """(b): the switch-MoE encoder at Switch-Base-8 widths, experts over the
    ep mesh and unsharded."""
    import dataclasses

    from nnstreamer_tpu_torch.elements.transform import _bind_chain, _parse_arith_ops
    from nnstreamer_tpu_torch.models import transformer
    from nnstreamer_tpu_torch.parallel import moe

    sb = SWITCH_BASE
    t0 = time.perf_counter()
    tree = card_tree(torch, 11, sb["d_model"], sb["n_heads"], sb["n_layers"], sb["d_ff"],
                     MOE_WINDOW[1], MOE_OUT, experts=sb["experts"])
    base = transformer.build(seq_len=MOE_WINDOW[0], d_in=MOE_WINDOW[1], n_out=MOE_OUT,
                             d_model=sb["d_model"], n_heads=sb["n_heads"],
                             n_layers=sb["n_layers"], causal=False, dtype="bfloat16",
                             params=tree, moe_experts=sb["experts"], device=DEVICE)
    del tree
    build_s = time.perf_counter() - t0
    dt = torch.bfloat16

    ep = dataclasses.replace(
        base, name=f"switch_ep{PAR_SHARDS}", params=transformer.place_moe(base.params, mesh, "ep"),
        apply=lambda p, x: transformer.apply(p, x, causal=False, dtype=dt, moe_mesh=mesh,
                                             moe_axis="ep"))
    models = {"ep": ep, "unsharded": base}
    rng = np.random.default_rng(13)
    windows = [torch.from_numpy(rng.integers(-32768, 32768, MOE_WINDOW, dtype=np.int16))
               for _ in range(MOE_WINDOWS)]
    desc = ("datasrc name=s ! tensor_transform mode=arithmetic "
            f"option={MOE_NORMALIZE} acceleration=pallas ! tensor_upload name=u ! "
            "queue max-size-buffers=16 ! tensor_filter framework=torch name=f ! "
            "tensor_sink name=out")
    ops = _bind_chain(_parse_arith_ops(MOE_NORMALIZE), np.dtype(np.int16))
    out, outs = {"build_s": build_s}, {}
    for name, model in models.items():
        state = {}
        got = []

        def setup(p, ws=windows):
            p["s"].data = list(ws)

        def during(p):
            torch.cuda.synchronize()  # nothing on the path reads the outputs back
            state["end"] = time.perf_counter()
            be = p["f"].backend
            state.update(stats=dict(be.stats),
                         launches={k.__name__: k.launches for k in K.KERNELS})
            captured_against_eager(torch, be, [windows[0].cuda()], exact=True)

        K.reset_launches()
        _, arrivals, _ = run_pipeline(nns, desc, model, MOE_WINDOWS, during=during, got=got,
                                      setup=setup)
        vit_checks(state["stats"], state["launches"], MOE_WINDOWS)
        outs[name] = [f.tensor(0).float().cpu().numpy() for f in got]
        res = dict(frames=MOE_WINDOWS, replays=state["stats"]["replays"],
                   **rates(arrivals, np, state["end"]), capture_s=state["stats"]["capture_s"],
                   launches=state["launches"])
        profile_path(lambda n, model=model: traced_run(nns, desc, model, n,
                                                       setup=lambda p: setup(p, windows[:n])),
                     res, ("fused_arith",), attempts=PAR_TRACES)
        out[name] = res
        report_path(f"(b) switch-MoE {name}", res, card)
    # routing: the dropped tokens of each window (eager, the ep model)
    dropped, layer0_equal = [], True
    with torch.inference_mode():
        for i, w in enumerate(windows):
            x = K.fused_arith(w.cuda(), ops)
            with moe.record_routes() as routes:
                models["ep"](x)
            dropped.append(sum(int((~r["keep"]).sum()) for r in routes))
            if i == 0:
                with moe.record_routes() as plain:
                    models["unsharded"](x)
                layer0_equal = all(torch.equal(routes[0][k], plain[0][k])
                                   for k in ("expert", "pos", "keep"))
                real_out = transformer.apply(base.params, x, causal=False, dtype=dt,
                                             moe_mesh=real, moe_axis="ep")
                real_rel = float((real_out.float() - torch.from_numpy(outs["unsharded"][0])
                                  .cuda()).abs().max() / np.abs(outs["unsharded"][0]).max())
    check(layer0_equal, "(b) the first layer's routing differs between ep and unsharded")
    tokens = [a.reshape(-1, MOE_OUT) for a in outs["ep"]], \
        [b.reshape(-1, MOE_OUT) for b in outs["unsharded"]]
    top = max(float(np.abs(b).max()) for b in tokens[1])
    rel = max(float(np.abs(a - b).max()) for a, b in zip(*tokens)) / top
    share = float(np.mean(np.concatenate([a.argmax(-1) == b.argmax(-1)
                                          for a, b in zip(*tokens)])))
    check(rel <= MOE_REL and share >= MOE_ARGMAX_SHARE,
          f"(b) ep:{PAR_SHARDS} against unsharded: {rel} of the largest output (tolerance "
          f"{MOE_REL}), argmax equal on {share} of the tokens (at least {MOE_ARGMAX_SHARE})")
    check(real_rel <= MOE_REL, f"(b) on {real.size} real device(s): {real_rel}")
    out.update(rel_ep_to_unsharded=rel, argmax_share=share, layer0_routing_equal=layer0_equal,
               dropped_tokens_per_window=dropped,
               dropped_share=sum(dropped) / (MOE_WINDOWS * MOE_WINDOW[0] * SWITCH_BASE["n_layers"]),
               real_devices=real.size, real_rel=real_rel)
    print(f"(b) switch-MoE at Switch-Base-8 widths: ep:{PAR_SHARDS} within {rel:.3g} of the "
          f"unsharded run (tolerance {MOE_REL}), argmax equal on {share:.4f} of the tokens, "
          f"the first layer's routing equal; dropped tokens a window over its "
          f"{SWITCH_BASE['n_layers']} MoE layers {dropped}; build {build_s:.1f} s [{card}]",
          flush=True)
    return out


def gpipe_mesh_leg(torch, np, K, nns, card, mesh, real):
    """(c): build_pipelined at ViT-B's encoder widths against the
    sequential apply on the same tree."""
    from nnstreamer_tpu_torch.models import transformer

    c = PP_CFG
    tree = card_tree(torch, 17, c["d_model"], c["n_heads"], c["n_layers"], 4 * c["d_model"],
                     c["d_in"], c["n_out"])
    kw = dict(seq_len=c["seq_len"], d_in=c["d_in"], n_out=c["n_out"], d_model=c["d_model"],
              n_heads=c["n_heads"], n_layers=c["n_layers"], batch=PP_BATCH,
              microbatches=PP_MICRO, causal=False, params=tree, device=DEVICE)
    model = transformer.build_pipelined(mesh, "pp", **kw)
    seq = transformer.prepare(tree, torch.float32, DEVICE)
    rng = np.random.default_rng(19)
    batches = [torch.from_numpy(rng.standard_normal((PP_BATCH, c["seq_len"], c["d_in"]))
                                .astype(np.float32)) for _ in range(PP_BATCHES)]
    desc = ("datasrc name=s ! tensor_upload name=u ! queue ! tensor_filter framework=torch "
            "name=f ! tensor_sink name=out")
    state, got = {}, []

    def setup(p, bs=batches):
        p["s"].data = list(bs)

    def during(p):
        torch.cuda.synchronize()  # nothing on the path reads the outputs back
        state["end"] = time.perf_counter()
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS})
        captured_against_eager(torch, be, [b.cuda() for b in batches[:2]], exact=True)

    K.reset_launches()
    _, arrivals, _ = run_pipeline(nns, desc, model, PP_BATCHES, during=during, got=got,
                                  setup=setup)
    stats = state["stats"]
    check(stats["captures"] == 1 and stats["replays"] == PP_BATCHES, f"(c) {stats}")
    check(all(v == 0 for v in state["launches"].values()),
          f"(c) a kernel launched off this path: {state['launches']}")
    with torch.inference_mode():
        wants = [transformer.apply(seq, b.cuda(), causal=False).cpu().numpy()
                 for b in batches[:2]]
        one = transformer.build_pipelined(real, "pp", **kw)  # the real device count
        real_rel = float(np.abs(one(batches[0].cuda()).cpu().numpy() - wants[0]).max()
                         / np.abs(wants[0]).max())
    rel = rows_check(np, [r for f in got[:2] for r in f.tensor(0).cpu().numpy()
                          .reshape(-1, c["n_out"])],
                     [r for w in wants for r in w.reshape(-1, c["n_out"])], PP_REL)
    check(real_rel <= PP_REL, f"(c) on {real.size} real device(s): {real_rel}")
    res = dict(batches=PP_BATCHES, replays=stats["replays"], **rates(arrivals, np, state["end"]),
               capture_s=stats["capture_s"], rel_to_sequential=rel, real_devices=real.size,
               real_rel=real_rel)
    tr = traced_run(nns, desc, model, PROFILED,
                    setup=lambda p: setup(p, [batches[i % PP_BATCHES] for i in range(PROFILED)]))
    launches = tr["calls"].get("cudaGraphLaunch", 0) + tr["calls"].get("cuGraphLaunch", 0)
    check(launches == PROFILED and not any(tr["records"].values()),
          f"(c) {launches} graph launches for {PROFILED} batches, kernel records "
          f"{tr['records']} (none of the three on this path)")
    busy = tr["busy_ms"] / PROFILED
    res.update(device_busy_ms_per_batch=busy, device_idle_share=1 - busy * res["fps"] / 1e3,
               tokens_per_s=res["fps"] * PP_BATCH * c["seq_len"],
               device_records_per_launch=max(t for _, t in tr["per_launch"]),
               host_ops_per_batch=host_ops(tr["calls"]) / PROFILED)
    print(f"(c) GPipe at ViT-B widths over pp:{PAR_SHARDS}: {PP_BATCHES} batches, one capture; "
          f"replays bitwise equal to eager; within {rel:.3g} of the sequential apply "
          f"(tolerance {PP_REL}), every token's argmax equal; {res['fps']} batches/s, device "
          f"busy {busy} ms a batch, idle share {res['device_idle_share']} [{card}]", flush=True)
    return res


def mesh_frames(np, torch, Frame, rng, n, rounds):
    """Config 5's frames under the mesh: stream i is 127 plus uniform noise
    of MESH_CONTRAST[i], so that each shard's activations peak apart."""
    return [[Frame.of(torch.from_numpy(np.clip(127 + rng.integers(
        -MESH_CONTRAST[i], MESH_CONTRAST[i] + 1, (IMAGE, IMAGE, 3)), 0, 255).astype(np.uint8)),
        pts=r) for r in range(rounds)] for i in range(n)]


def dispatch_mesh_leg(torch, np, K, nns, ops, card, keep):
    """(d) and (e): config 5 and config 1d under NNSTPU_MESH=dp:4, the
    torch-sharded backend, the device lane's series a shard, and the clamp
    of NNSTPU_MESH=auto on the real cards."""
    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.obs.device import DeviceTracer
    from nnstreamer_tpu_torch.obs.export import render_text
    from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
    from nnstreamer_tpu_torch.parallel import mesh as pmesh

    ckpt = keep["batch"]["ckpt"]
    n, shards = MESH_STREAMS, PAR_SHARDS
    builder = "build_quantized,int8_head=1"
    desc = batch_desc(n, ckpt, builder)
    rng = np.random.default_rng(23)
    frames = mesh_frames(np, torch, Frame, rng, n, MESH_ROUNDS)
    kernels = ("fused_arith", "int8_matmul")
    out = {}

    def set_mesh(spec):
        if spec is None:
            os.environ.pop("NNSTPU_MESH", None)
        else:
            os.environ["NNSTPU_MESH"] = spec
        pmesh.reset_dispatch_mesh()

    state = {}

    def during(p):
        be = p["f"].backend
        state.update(stats=dict(be.stats), launches={k.__name__: k.launches for k in K.KERNELS},
                     folded=not any(type(x).__name__ == "TensorTransform"
                                    for x in p.nodes.values()),
                     segments=getattr(be._entry, "segments", 0),
                     shards=len(getattr(be._entry, "devs", ())))
        with torch.inference_mode():
            state["eager"] = [be.eager(torch.stack([frames[i][r].tensor(0) for i in range(n)])
                                       .cuda())[0].cpu().numpy() for r in range(MESH_EAGER)]

    walls, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        walls[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    try:
        set_mesh(f"dp:{shards}")
        K.reset_launches()
        _, got, arrivals, _ = run_batch(nns, torch, desc, n, frames, during=during)
        lap("config5")
        check(state["folded"], "(d): the normalize did not fold into the filter")
        check(state["segments"] == 2 and state["shards"] == shards,
              f"(d): {state['shards']} shards of {state['segments']} segments, expected "
              f"{shards} of 2 (the int8 head's scale is a collective)")
        sharded_capture_check(state["stats"], MESH_ROUNDS, state["launches"], kernels, shards)
        stream_check(np, {i: f[:MESH_EAGER] for i, f in got.items()}, state["eager"], MESH_EAGER)
        rows = [got[i][r] for r in range(MESH_ROUNDS) for i in range(n)]
        r = rates(arrivals, np)
        res = dict(streams=n, shards=shards, rounds=MESH_ROUNDS, fps=r["fps"],
                   frames_per_s=r["fps"] * n, p50_ms=r["p50_ms"], p90_ms=r["p90_ms"],
                   capture_s=state["stats"]["capture_s"], launches=state["launches"],
                   fused_arith_folded_per_shard=True)
        tr = run_batch(nns, torch, desc, n, mesh_frames(np, torch, Frame, rng, n, PROFILED),
                       traced=True)[3]
        rounds, counts, lost = shard_launch_check(tr, shards, [("fused_arith",),
                                                               ("int8_matmul",)])
        check(rounds == PROFILED, f"(d): {rounds} rounds of graph launches for {PROFILED}")
        check(counts.get("fused_arith", 0) + lost >= PROFILED * shards
              and counts.get("int8_matmul", 0) + lost >= PROFILED * shards,
              f"(d): kernel records {counts} over {PROFILED} rounds of {shards} shards")
        lap("config5_trace")
        busy = tr["busy_ms"] / PROFILED
        res.update(kernel_records=counts, records_lost_by_tracer=lost,
                   graph_launches_per_round=len(tr["per_launch"]) / PROFILED,
                   fused_arith_records_per_round=counts.get("fused_arith", 0) / PROFILED,
                   int8_matmul_records_per_round=counts.get("int8_matmul", 0) / PROFILED,
                   device_busy_ms_per_round=busy, device_idle_share=1 - busy * r["fps"] / 1e3,
                   host_ops_per_round=host_ops(tr["calls"]) / PROFILED)

        # the same frames through torch-sharded, with (e): the device lane,
        # one series a shard
        set_mesh(None)
        sdesc = desc.replace("framework=torch ", "framework=torch-sharded ").replace(
            f"custom=builder={builder}", f"custom=builder={builder},devices={shards},axis=dp")
        reg = MetricsRegistry()
        tracer = DeviceTracer(registry=reg)
        _, sgot, _, _ = run_batch(
            nns, torch, sdesc, n, frames, setup=lambda p: p.attach_tracer(tracer),
            during=lambda p: wait_until(lambda: tracer.summary()["completed"] >= MESH_ROUNDS,
                                        30, "(e): the reaper"))
        check(all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                  for i in range(n) for a, b in zip(sgot[i], got[i])),
              "(d): torch-sharded's rows differ from the dispatch mesh's")
        summ = tracer.summary()
        labels = sorted(summ["by_device"])
        series = [ln for ln in render_text(reg).splitlines()  # the histogram's count a series
                  if ln.split("{")[0] == "nnstpu_device_exec_seconds" + "_count"]
        check(labels == [f"cuda:{i}" for i in range(shards)] and len(series) == shards
              and summ["completed"] == summ["dispatches"] == MESH_ROUNDS,
              f"(e): devices {labels}, {len(series)} series, {summ['completed']} of "
              f"{summ['dispatches']} reaped")
        res["device_lane"] = {lb: summ["by_device"][lb] for lb in labels}
        lap("torch_sharded_device_lane")
        _, ugot, _, _ = run_batch(nns, torch, desc, n, frames)
        urows = [ugot[i][r] for r in range(MESH_ROUNDS) for i in range(n)]
        rel = rows_check(np, rows, urows, BATCH_INT8_LOGIT_REL)
        lap("unsharded")
        scale_check = batch_scale_check(torch, np, K, ops, ckpt, frames, n, shards)
        lap("scale_check")
        res.update(rel_to_unsharded=rel, **scale_check)
        print(f"(d) config 5, {n} streams, int8 head, NNSTPU_MESH=dp:{shards}: {MESH_ROUNDS} "
              f"rounds, one capture of {shards} shards x 2 segments (the int8 head's scale "
              f"reduced between them); rows bit for bit the sharded eager forward and "
              f"torch-sharded's, within {rel:.3g} of the unsharded filter (tolerance "
              f"{BATCH_INT8_LOGIT_REL}), top-1 equal; the shards' int8 activations and scale "
              f"bit for bit the whole batch's (shard maxima {res['shard_scales']}, a per-shard "
              f"scale would move a row by {res['per_shard_scale_control']:.3g} of its own "
              f"largest logit); {res['graph_launches_per_round']} graph launches, "
              f"{res['fused_arith_records_per_round']} fused_arith and "
              f"{res['int8_matmul_records_per_round']} int8_matmul records a round (the "
              f"normalize folded into each shard's capture); {res['frames_per_s']} frames/s, "
              f"busy {busy} ms a round [{card}]", flush=True)
        print(f"(e) device lane: one series a shard, {res['device_lane']} [{card}]", flush=True)
        out["config5"] = res

        # config 1d under the mesh: buckets shards x {1, 2, 4, 8}
        set_mesh(f"dp:{shards}")
        os.environ["NNSTPU_COMPILE_WARMUP"] = "1"
        try:
            out["config1d"] = dyn_mesh_run(torch, np, K, nns, keep, card, shards)
        finally:
            os.environ.pop("NNSTPU_COMPILE_WARMUP", None)
        lap("config1d")
        out["wall_s"] = walls

        # NNSTPU_MESH=auto on the real cards: off with one, as in the reference
        pmesh.force_device_count(None)
        set_mesh("auto")
        real = len(pmesh.visible_devices())
        got_ndev = pmesh.dispatch_mesh_devices()
        check(got_ndev == (real if real > 1 else 1),
              f"NNSTPU_MESH=auto on {real} device(s): a mesh of {got_ndev}")
        out["auto_on_real_cards"] = got_ndev
    finally:
        set_mesh(None)
    return out


def batch_scale_check(torch, np, K, ops, ckpt, frames, n, shards):
    """The int8 head's collective on the card: the first round's features
    quantized as ``shards`` shards of one sharded call (``ShardRun``, the
    phase runner of the sharded capture) give each shard the whole batch's
    scale and int8 activations, bit for bit; the shards' own maxima differ
    (else the frames would not exercise the reduction).  Also the control:
    how far a per-shard scale moves a row, relative to the row's largest
    logit."""
    from nnstreamer_tpu_torch.backends.sharded import ShardRun
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.ops.quant import quantize_activations
    from nnstreamer_tpu_torch.utils.checkpoint import load_state

    model = mobilenet_v2.build_quantized(params=load_state(ckpt), int8_head=True,
                                         image_size=IMAGE, device=DEVICE)
    with torch.inference_mode():
        x = torch.stack([K.fused_arith(frames[i][0].tensor(0).cuda(), ops) for i in range(n)])
        feats = mobilenet_v2.features(model.params, x, torch.bfloat16).float()
        parts = feats.chunk(shards)
        dev = feats.device
        got = ShardRun([quantize_activations] * shards, [(f,) for f in parts],
                       [dev] * shards).run()
        q_all, s_all = quantize_activations(feats)
        own = [float(quantize_activations(f)[1]) for f in parts]
        whole = model(x).cpu().numpy()
        per_shard = torch.cat([model(c) for c in x.chunk(shards)]).cpu().numpy()
    check(all(torch.equal(s, s_all) for _, s in got)
          and torch.equal(torch.cat([q for q, _ in got]), q_all),
          "(d): a shard's int8 activations or scale differ from the whole batch's")
    check(len(set(own)) > 1, f"(d): the shards' own scales {own} are all equal: these frames "
                             "do not exercise the reduction")
    control = max(float(np.abs(a - b).max()) / max(float(np.abs(a).max()),
                                                    float(np.abs(b).max()), 1e-30)
                  for a, b in zip(per_shard, whole))
    return dict(batch_scale=float(s_all), shard_scales=own, per_shard_scale_control=control)


def dyn_mesh_run(torch, np, K, nns, keep, card, shards):
    """Config 1d under the dispatch mesh: every bucket shards x {1, 2, 4, 8}
    captured before PLAYING (a graph a shard a bucket) and nothing after,
    every frame out once in pts order, each batch's rows the sharded eager
    forward of the same rows bit for bit."""
    from nnstreamer_tpu_torch.buffer import Frame

    poly, dyn_frames = keep["batch"]["poly"], keep["batch"]["dyn_frames"]
    batches = []
    p = nns.parse_launch(dyn_desc())
    p["s"].data = [Frame.of(x, pts=i) for i, x in enumerate(dyn_frames)]
    p["f"].model = poly
    push = p["dyn"].push

    def recording_push(frame, pad_name=None):
        batches.append((list(frame.meta["dynbatch"]["pts"]), int(frame.tensors[0].shape[0])))
        push(frame, pad_name)

    p["dyn"].push = recording_push
    got = []
    p["out"].connect("new-data", lambda f: got.append((f.pts, f.tensor(0).numpy())))
    K.reset_launches()
    p.start()
    try:
        be = p["f"].backend
        before = be.stats["captures"]
        check(p.wait(600), "config 1d under the mesh did not finish")
        after = be.stats["captures"]
        eager = {}
        with torch.inference_mode():
            for pts, b in batches:
                x = torch.stack([dyn_frames[i] for i in pts]
                                + [dyn_frames[pts[-1]]] * (b - len(pts))).cuda()
                eager[tuple(pts)] = be.eager(x)[0].cpu().numpy()
        report = p.warmup_report
    finally:
        p.stop()
    ladder_ = [shards * b for b in ladder(DYN_MAX_BATCH)]
    check(before == len(ladder_) + 1 and after == before,
          f"config 1d: {before} captures before the first frame (the ladder {ladder_} and "
          f"the negotiated batch of 1), {after - before} while PLAYING")
    check([c["label"] for c in report["compiled"]] == [f"bucket{b}" for b in ladder_],
          f"config 1d's warmup report {report}")
    buckets = [b for _, b in batches]
    check(all(b in ladder_ for b in buckets), f"config 1d buckets {sorted(set(buckets))}")
    pts_out = [pts for pts, _ in got]
    check(pts_out == sorted(pts_out) == list(range(len(dyn_frames))),
          "config 1d: frames out of order or missing")
    by_pts = dict(got)
    for pts, b in batches:
        for j, f in enumerate(pts):
            check(np.array_equal(by_pts[f].view(np.uint32), eager[tuple(pts)][j].view(np.uint32)),
                  f"config 1d frame {f} (bucket {b}): the replay's row differs from the "
                  "sharded eager forward")
    launches = {k.__name__: k.launches for k in K.KERNELS}
    res = dict(frames=len(dyn_frames), batches=len(buckets),
               buckets={str(b): buckets.count(b) for b in ladder_},
               captures_before_playing=before, warmup_s=report["seconds"], launches=launches)
    print(f"config 1d under dp:{shards}: {len(dyn_frames)} frames, {before} captures before "
          f"the first frame (buckets {ladder_} a graph a shard, and the negotiated batch of "
          f"1), none while PLAYING; rows bit for bit the sharded eager forward; buckets "
          f"{res['buckets']} [{card}]", flush=True)
    return res


def parallel_phase(torch, np, K, ops, root, card, keep):
    """Phase 30, the mesh: (a) to (e) over a forced mesh of PAR_SHARDS
    copies of the card, each in-model leg also on the real device count."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.parallel import mesh as pmesh

    for leg, what in parallel_legs().items():
        print(f"mesh leg ({leg}): {what}", flush=True)
    t0 = time.perf_counter()
    real = pmesh.visible_devices()  # the cards there are
    pmesh.force_device_count(PAR_SHARDS)
    try:
        launches, res = {}, {}
        K.reset_launches()
        res["vit"] = vit_mesh_leg(torch, np, K, nns, ops, card, keep,
                                  pmesh.make_mesh((PAR_SHARDS,), ("sp",)),
                                  pmesh.make_mesh((len(real),), ("sp",), real))
        for mode in ("ring", "ulysses"):
            launches[f"mesh_vit_{mode}"] = res["vit"][mode]["launches"]
        t1 = time.perf_counter()
        res["moe"] = moe_mesh_leg(torch, np, K, nns, card,
                                  pmesh.make_mesh((PAR_SHARDS,), ("ep",)),
                                  pmesh.make_mesh((len(real),), ("ep",), real))
        for name in ("ep", "unsharded"):
            launches[f"mesh_moe_{name}"] = res["moe"][name]["launches"]
        t2 = time.perf_counter()
        res["gpipe"] = gpipe_mesh_leg(torch, np, K, nns, card,
                                      pmesh.make_mesh((PAR_SHARDS,), ("pp",)),
                                      pmesh.make_mesh((len(real),), ("pp",), real))
        t3 = time.perf_counter()
        res["dispatch"] = dispatch_mesh_leg(torch, np, K, nns, ops, card, keep)
        launches["mesh_config5"] = res["dispatch"]["config5"]["launches"]
        launches["mesh_config1d"] = res["dispatch"]["config1d"]["launches"]
    finally:
        pmesh.force_device_count(None)
    res["wall_s"] = dict(vit=t1 - t0, moe=t2 - t1, gpipe=t3 - t2,
                         dispatch=time.perf_counter() - t3, total=time.perf_counter() - t0)
    print(f"mesh phase wall s: {res['wall_s']} [{card}]", flush=True)
    return launches, res


def _conv_dicts(tree):
    """Every dict of a params tree that holds a weight ``"w"``, in order."""
    if isinstance(tree, dict):
        return ([tree] if "w" in tree else []) + [d for v in tree.values()
                                                 for d in _conv_dicts(v)]
    if isinstance(tree, list):
        return [d for v in tree for d in _conv_dicts(v)]
    return []


FLEET_TENANTS = 4          # (a): the load generator's tenants ...
FLEET_RATE = 25.0          # ... each an open-loop constant rate, requests a second ...
FLEET_SECONDS = 5.2        # ... over this long (about 520 arrivals)
FLEET_MIN_REQUESTS = 400
FLEET_FRAMES = 32          # distinct camera frames the requests carry
FLEET_TICK_S = 0.25        # the chaos clock: one fleet consultation a worker a tick
FLEET_KILL_AFTER = 8       # worker_kill fires at the ninth tick of the victim
FLEET_JOIN_LIMIT_S = 180   # spawn (import, kernel load, capture) to routable
FLEET_ENGINE = dict(ENGINE_WIDE)  # (b): config 4d's engine at full width
FLEET_CAPACITY = 8
FLEET_SESSIONS = 8
FLEET_PROMPT = 32          # prefill tokens a session
FLEET_STEPS = 12           # decode steps a session ...
FLEET_DRAIN_AT = 6         # ... the drain comes after this many
FLEET_D_RATE = 40.0        # (d): the forensics burst against (a)'s fleet
FLEET_D_SECONDS = 3.0
# the respawned (a) worker's fault: its first 20 requests clean (the
# forensics baseline warms on them), then every third delayed 150 ms inside
# its device_invoke span
FLEET_D_FAULTS = "seed=9;invoke_delay@query_server:after=20,every=3,ms=150"
FLEET_D_SLO = "fleet:nnstpu_e2e_latency_ms{pipeline=fleet-d}<100ms@0.99"
FLEET_D_MIN_SAMPLES = 16
FLEET_PROFILE_S = 1.0      # the worker's profile window under load ...
FLEET_PROFILE_RATE = 20.0  # ... a constant load straight at that worker ...
FLEET_PROFILE_LOAD_S = 10.0  # ... this long, the window opening 1 s in
FLEET_C_BASE = 5.0         # (c): the spike profile's base and peak rates ...
FLEET_C_PEAK = 50.0
FLEET_C_WORKER_RPS = 25.0  # ... against this per-worker capacity: 1 worker, then 2
FLEET_EXIT_LIMIT_S = 60.0  # a drained worker's SIGTERM to its exit
FLEET_C_PRE_S = 3.0
FLEET_C_SPIKE_S = 3.0      # far shorter than a worker's start (process up, then capture):
                           # the load falls back while the scale-up still joins
FLEET_C_POST_S = 10.0      # the tail at the base rate (the controller goes on after it)
FLEET_C_HISTORY_S = 8.0    # the forecast's history: one low reading of the load (a starved
                           # tick) cannot drain a worker mid-spike


def fleet_log_tails(logs, lines=30):
    """The last lines of each worker log, for a failure's standard error."""
    for path in logs:
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                tail = f.readlines()[-lines:]
        except OSError:
            continue
        print(f"--- {path} (last {len(tail)} lines)", file=sys.stderr)
        sys.stderr.writelines(tail)
    sys.stderr.flush()


# a stateless worker's wrapper calls at its join: its warmup capture's (3
# warm-up calls and the capture); a decode worker launches none of them
FLEET_CAPTURE_CALLS = {"fused_arith": 4, "int8_matmul": 4, "pallas_nms_keep": 0}


def fleet_join_check(seen):
    """Each worker incarnation's kernel launch counts, read from its
    ``/stats.json`` at its join (``(worker, nonce, counts or the read's
    error, device)``): a stateless worker's must be its warmup capture's,
    ``FLEET_CAPTURE_CALLS`` (one that joined before its capture, or served
    on another route than the graph, reads otherwise), a decode worker's
    (``fleet-b``) none.  Returns the faults found."""
    bad = []
    for worker, nonce, counts, _ in seen:
        if not isinstance(counts, dict):
            bad.append(f"{worker} ({nonce}): /stats.json unread at its join: {counts}")
            continue
        want = (dict.fromkeys(FLEET_CAPTURE_CALLS, 0) if worker.startswith("fleet-b")
                else FLEET_CAPTURE_CALLS)
        if counts != want:
            bad.append(f"{worker} ({nonce}): launches {counts} at its join, not {want}")
    return bad


def fleet_replay_check(worker, st, routed=None):
    """A stateless worker's ``/stats.json`` entry against what it served:
    its one capture (the warmup's), and one graph replay for each invoke
    and each reply (a request served eagerly shows here); ``routed``, where
    given, is the router's count of replies from this worker.  Returns the
    faults found."""
    q = st["query"]
    g = q["graphs"]
    bad = []
    if g["captures"] != 1:
        bad.append(f"{worker}: {g['captures']} captures, not 1")
    if not g["replays"] == q["invokes"] == q["replies"]:
        bad.append(f"{worker}: {g['replays']} graph replays for {q['invokes']} invokes and "
                   f"{q['replies']} replies")
    if routed is not None and q["replies"] != routed:
        bad.append(f"{worker}: {q['replies']} replies, the router counts {routed}")
    return bad


def fleet_chain(index, offsets):
    """The trace ids whose spans run client -> router -> worker -> device:
    an ``nnsq_rtt`` and its child ``nnsq_route`` in this process, the
    route's child ``nnsq_serve`` and that span's ``device_exec`` in a worker,
    the worker's spans inside the route's within the clock offset's error
    bound (half the best probe's round trip) and the device span starting
    inside the serve span.  ``index`` is ``TraceCollector.spans_by_trace``'s,
    ``offsets`` maps a source to its probe round trip (ns)."""
    good = []
    for tid, recs in index.items():
        by = {}
        for r in recs:
            by.setdefault(r[4], []).append(r)
        for rtt in by.get("nnsq_rtt", ()):
            routes = [r for r in by.get("nnsq_route", ()) if r[8] == rtt[7]]
            for route in routes:
                for serve in (r for r in by.get("nnsq_serve", ()) if r[8] == route[7]):
                    err = offsets.get(serve[10], 0) / 2 + 50_000
                    devs = [d for d in by.get("device_exec", ())
                            if d[8] == serve[7] and d[10] == serve[10]]
                    if not (rtt[1] <= route[1] and route[1] + route[2] <= rtt[1] + rtt[2]):
                        continue
                    if not (route[1] - err <= serve[1]
                            and serve[1] + serve[2] <= route[1] + route[2] + err):
                        continue
                    if any(serve[1] <= d[1] <= serve[1] + serve[2] for d in devs):
                        good.append(tid)
    return sorted(set(good))


def fleet_phase(torch, np, K, root, card):
    """Phase 31, the fleet tier: worker subprocesses on the card behind the
    port's router, membership, supervisor and autoscaler, driven by the
    port's load generator.  (a) two fragment workers serving slice 1 under an
    open-loop load with a seeded worker_kill, every reply bitwise the
    in-process slice's; (b) two DecodeServer workers at config 4d's width,
    8 sessions, one worker drained with live migration through a repo
    process; (c) the autoscaler over (a)'s worker arguments, 1 -> 2 -> 1 on
    a spike shorter than a worker's start (the scale-up cancelled while it
    joins, the floor serving throughout); (d) the merged trace, a worker
    profile under load, a forensics verdict and the merged SLO alert.  Kernel launches are counted in the
    workers (their /stats.json) and summed."""
    import threading

    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch import faults
    from nnstreamer_tpu_torch.elements import query
    from nnstreamer_tpu_torch.fleet import (Autoscaler, FleetChaos, Membership, Router,
                                            RouterSignals, SubprocWorkerFactory, Supervisor,
                                            Surface)
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.obs import collector as col
    from nnstreamer_tpu_torch.obs import hooks, spans
    from nnstreamer_tpu_torch.obs.forensics import ForensicsEngine
    from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
    from nnstreamer_tpu_torch.obs.slo import SloEngine
    from nnstreamer_tpu_torch.serving import ContinuousBatcher
    from nnstreamer_tpu_torch.tools import loadgen
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "chip_smoke")
    logdir = os.path.join(work, "fleet_logs")
    os.makedirs(logdir, exist_ok=True)
    tree = mobilenet_v2.init_tree(0, CLASSES, 1.0)  # slice 1's model (build_quantized seed 0)
    ckpt = os.path.join(work, "fleet_mobilenet_v2.npz")
    save_state(tree, ckpt)
    model_props = (f"model={ckpt} custom=builder=mobilenet_v2:build_quantized,int8_head=1,"
                   f"image_size={IMAGE},num_classes={CLASSES}")
    normalize = (f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas "
                 f"device={DEVICE}")
    fragment = f"{normalize} ! tensor_filter framework=torch name=f {model_props}"
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["NNSTPU_OBS_COSTMODEL_PATH"] = os.path.join(work, "fleet_COST_MODEL.json")
    env.pop("NNSTPU_FAULTS", None)
    stateless_args = ["--framework", "fragment", "--model", fragment,
                      "--warmup-spec", f"uint8:{IMAGE}x{IMAGE}x3", "--spans",
                      "--tracers", "device;costmodel"]
    engine_kv = ",".join(f"{k}={v}" for k, v in
                         dict(capacity=FLEET_CAPACITY, seed=0, **FLEET_ENGINE).items())
    decode_args = ["--decode", engine_kv, "--spans"]
    logs, files, handles_seen, res = [], [], [], {}
    tally = {k.__name__: 0 for k in K.KERNELS}
    stop_evt = threading.Event()

    def factory(name, args):
        path = os.path.join(logdir, f"{name}.log")
        logs.append(path)
        files.append(open(path, "w", encoding="utf-8"))
        return SubprocWorkerFactory(args, env=dict(env), device=DEVICE,
                                    line_timeout_s=FLEET_JOIN_LIMIT_S, stderr=files[-1])

    m_a, m_b, m_c = (Membership(heartbeat_s=0.25, probe_timeout_s=5.0) for _ in range(3))
    r_a = Router(m_a, name="fleet-a")
    r_c = Router(m_c, name="fleet-c")
    f_a = factory("fleet-a", stateless_args)
    sup_a = Supervisor(f_a, [Surface(m_a, r_a)], name="fleet-a",
                       spawn_timeout_s=FLEET_JOIN_LIMIT_S, respawn_backoff_ms=0)
    sup_c = Supervisor(factory("fleet-c", stateless_args), [Surface(m_c, r_c)], name="fleet-c",
                       spawn_timeout_s=FLEET_JOIN_LIMIT_S, drain_deadline_s=FLEET_EXIT_LIMIT_S)
    repo_proc = None
    r_b = sup_b = autoscaler = None
    sups = [sup_a, sup_c]
    was_spans = spans.enabled
    spans.enable()

    def on_scale(name, action, worker, detail):
        """Each worker incarnation's kernel launch counts, read from its
        /stats.json as it joins (on the supervision pass's thread, before the
        controller of that pass can drain it; the counts come from its warmup
        capture, its requests replay)."""
        del detail
        if action != "join":
            return
        sup = next(s for s in sups if s.name == name)
        h = sup.get(worker).handle
        try:
            st = col.http_get_json(f"http://{h.ports['health_addr']}/stats.json",
                                   30)[f"worker:{worker}"]
        except Exception as exc:  # noqa: BLE001 - kept, and the hook stays connected
            handles_seen.append((worker, h.nonce, repr(exc), None))
            return
        for k, v in st["kernels"].items():
            tally[k] += v
        handles_seen.append((worker, h.nonce, st["kernels"], st.get("device")))

    def spawn_async(sup, n):
        threads = [threading.Thread(target=sup.spawn_worker, kwargs=dict(detail="start"))
                   for _ in range(n)]
        for t in threads:
            t.start()
        return threads

    def start_ticker(pairs, done):
        """Supervise the starting workers until ``done`` is set: each
        join (its warmup capture done) lands in the scale-event log as it
        happens."""
        def run():
            while not done.is_set() and not stop_evt.is_set():
                for sup, _ in pairs:
                    sup.tick()
                time.sleep(0.05)

        t = threading.Thread(target=run, daemon=True, name="fleet-start")
        t.start()
        return t

    def wait_ready(pairs, what):
        deadline = time.monotonic() + FLEET_JOIN_LIMIT_S
        while time.monotonic() < deadline:
            for sup, _ in pairs:
                check(sup.spawn_failed == 0, f"fleet {what}: a spawn failed: "
                      f"{sup.events.snapshot()[-3:]}")
            if all(sup.ready_count() >= n for sup, n in pairs):
                return
            time.sleep(0.05)
        fail(f"fleet {what}: workers not routable within {FLEET_JOIN_LIMIT_S} s: "
             f"{[sup.stats()['workers'] for sup, _ in pairs]}")

    def worker_stats(sup, wid):
        addr = sup.get(wid).handle.ports["health_addr"]
        return col.http_get_json(f"http://{addr}/stats.json", 30)[f"worker:{wid}"]

    def join_seconds(sup, t_start):
        """Seconds from the spawn's start to each worker's join, by wid."""
        out = {}
        for e in sup.events.snapshot():
            if e["action"] == "join":
                out[e["worker"]] = e["t"] - t_start
        return out

    try:
        for r in (r_a, r_c):
            r.start()
        for m in (m_a, m_b, m_c):
            m.start()
        # -- every worker starts now, in parallel: (a)'s two, (b)'s two, (c)'s floor
        t_spawn = time.monotonic()
        threads = spawn_async(sup_a, 2) + spawn_async(sup_c, 1)
        repo_proc = subprocess.Popen(
            [sys.executable, "-m", "nnstreamer_tpu_torch.fleet", "repo", "--port", "0",
             "--device", DEVICE], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env)
        repo_port = json.loads(repo_proc.stdout.readline())["port"]
        saved = os.environ.get("NNSTPU_FLEET_REPO_ADDR")
        os.environ["NNSTPU_FLEET_REPO_ADDR"] = f"127.0.0.1:{repo_port}"
        try:
            r_b = Router(m_b, stateful=True, name="fleet-b").start()  # [fleet] repo_addr
        finally:
            if saved is None:
                del os.environ["NNSTPU_FLEET_REPO_ADDR"]
            else:
                os.environ["NNSTPU_FLEET_REPO_ADDR"] = saved
        check(r_b.repo_addr == f"127.0.0.1:{repo_port}" and r_b.migrate_enabled,
              f"fleet (b): [fleet] repo_addr was not picked up: {r_b.stats()['migration']}")
        sup_b = Supervisor(factory("fleet-b", decode_args),
                           [Surface(m_b, r_b, port_key="decode_port", name="decode")],
                           name="fleet-b", spawn_timeout_s=FLEET_JOIN_LIMIT_S)
        sups.append(sup_b)
        threads += spawn_async(sup_b, 2)
        hooks.connect("scale_event", on_scale)
        started = [(sup_a, 2), (sup_b, 2), (sup_c, 1)]
        start_done = threading.Event()
        ticker = start_ticker(started, start_done)

        # while they start: the in-process references, slice 1 on (a)'s frames
        # and config 4d's engine alone on (b)'s sessions
        rng = np.random.default_rng(21)
        frames = [rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
                  for _ in range(FLEET_FRAMES)]
        ref_desc = (f"datasrc name=x ! {normalize} ! tensor_upload name=u ! "
                    f"queue max-size-buffers=16 ! tensor_filter framework=torch name=f "
                    f"{model_props} ! tensor_sink name=out collect=true")
        ref_p, _, _ = run_pipeline(nns, ref_desc, None, FLEET_FRAMES,
                                   setup=lambda p: setattr(
                                       p["x"], "data", [torch.from_numpy(f) for f in frames]))
        ref = [f.tensor(0).cpu().numpy() for f in ref_p["out"].frames]
        d_in = FLEET_ENGINE["d_in"]
        prompts = [rng.standard_normal((FLEET_PROMPT, d_in)).astype(np.float32)
                   for _ in range(FLEET_SESSIONS)]
        steps = [list(rng.standard_normal((FLEET_STEPS, d_in)).astype(np.float32))
                 for _ in range(FLEET_SESSIONS)]
        with ContinuousBatcher(capacity=FLEET_CAPACITY, seed=0, device=DEVICE,
                               **FLEET_ENGINE) as eng:
            alone = [served_alone(eng, 0, steps[k], prompt=prompts[k])
                     for k in range(FLEET_SESSIONS)]
        for t in threads:
            t.join(timeout=FLEET_JOIN_LIMIT_S)
        wait_ready(started, "start")
        start_done.set()
        ticker.join(timeout=30)
        joins = {**join_seconds(sup_a, t_spawn), **join_seconds(sup_b, t_spawn),
                 **join_seconds(sup_c, t_spawn)}
        res["spawn_to_routable_s"] = joins
        print(f"fleet: {len(joins)} worker subprocesses routable, spawn to routable s "
              f"{ {w: round(s, 3) for w, s in joins.items()} } (import, kernel load, "
              f"capture; all started together) [{card}]", flush=True)

        # -- (a) stateless, full width, with a seeded worker_kill -------------------
        wids = sorted(mw.wid for mw in sup_a.managed())
        victim, keeper = wids[-1], wids[0]
        f_a.env["NNSTPU_FAULTS"] = FLEET_D_FAULTS  # the victim's respawn carries (d)'s fault
        chaos = FleetChaos({w: sup_a.get(w).handle for w in wids})
        states = []
        tenants = [dict(name=f"tenant-{k}", workload="slice1",
                        profile=dict(kind="constant", rate=FLEET_RATE))
                   for k in range(FLEET_TENANTS)]
        workloads = {t["name"]: loadgen.Workload(
            "slice1", payload=lambda seq, k=k: [(frames[(seq * FLEET_TENANTS + k)
                                                        % FLEET_FRAMES],)])
            for k, t in enumerate(tenants)}
        lg = loadgen.LoadGen(("127.0.0.1", r_a.port), tenants, FLEET_SECONDS, seed=21,
                             metric_pipeline="fleet-a", keep_replies=True)
        planned = len(lg.schedule())
        check(planned >= FLEET_MIN_REQUESTS,
              f"fleet (a): the seeded plan holds {planned} requests (< {FLEET_MIN_REQUESTS})")
        prof = {}

        def background():
            # the supervision pass and the chaos clock (a respawn blocks
            # this thread while the new process starts)
            ticks = 0
            while not stop_evt.is_set() and not prof.get("done_a"):
                sup_a.tick()
                if ticks % max(1, int(FLEET_TICK_S / 0.05)) == 0:
                    chaos.tick()
                ticks += 1
                time.sleep(0.05)

        def sample_states():
            while not stop_evt.is_set() and not prof.get("done_a"):
                states.append(m_a.get(victim).state)
                time.sleep(0.01)

        faults.install(f"seed=21;worker_kill@{victim}:after={FLEET_KILL_AFTER}")
        bg = threading.Thread(target=background, daemon=True, name="fleet-a-supervise")
        sm = threading.Thread(target=sample_states, daemon=True, name="fleet-a-states")
        try:
            bg.start()
            sm.start()
            records = lg.run(workloads=workloads)
        finally:
            faults.deactivate()
        check(chaos.applied == [(victim, "worker_kill")],
              f"fleet (a): the seeded chaos applied {chaos.applied}")
        st_a = r_a.stats()
        ok = [r for r in records if r["status"] == "ok"]
        check(len(ok) == len(records) == planned,
              f"fleet (a): {len(records) - len(ok)} of {len(records)} requests failed: "
              f"{[(r['status'], r['code']) for r in records if r['status'] != 'ok'][:5]}")
        check(st_a["offered"] == st_a["delivered"] + st_a["shed_total"]
              and st_a["shed_total"] == 0 and st_a["offered"] == planned,
              f"fleet (a): router ledger offered {st_a['offered']}, delivered "
              f"{st_a['delivered']}, shed {st_a['shed']} (planned {planned})")
        bad = 0
        for r in ok:
            k = int(r["tenant"].rsplit("-", 1)[1])
            want = ref[(r["seq"] * FLEET_TENANTS + k) % FLEET_FRAMES]
            got = np.asarray(r["replies"][0][0])
            bad += not (got.shape == want.shape and np.array_equal(got, want))
        check(bad == 0, f"fleet (a): {bad} of {len(ok)} replies differ from the in-process "
                        "slice's on the same frame")
        lat = loadgen.summarize_ms([r["t_done_ns"] - r["t_sched_ns"] for r in ok])
        # the keeper alone served (a) from its warmup's graph: a replay a
        # request the router counts from it (the victim's first incarnation
        # died with its counts; its respawn is not routable yet)
        deadline = time.monotonic() + 10.0
        while True:
            keeper_bad = fleet_replay_check(keeper, worker_stats(sup_a, keeper),
                                            routed=m_a.get(keeper).routed)
            if not keeper_bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        check(not keeper_bad, f"fleet (a): {keeper_bad}")

        # while the killed worker respawns: (d)'s profile, a constant load
        # straight at the keeper with its /profile window opening 1 s in
        # (ROADMAP C17 one process over: the worker's replays and the
        # session's start and stop share its launch gate), beside (b) on its
        # own workers
        keeper_ports = sup_a.get(keeper).handle.ports
        lg_p = loadgen.LoadGen(("127.0.0.1", keeper_ports["port"]),
                               [dict(name="profiled", workload="slice1",
                                     profile=dict(kind="constant", rate=FLEET_PROFILE_RATE))],
                               FLEET_PROFILE_LOAD_S, seed=24, metric_pipeline="fleet-p")

        def profile_keeper():
            time.sleep(1.0)
            t0 = time.monotonic_ns()
            try:
                prof["summary"] = col.fetch_profile(keeper_ports["health_addr"],
                                                    seconds=FLEET_PROFILE_S, timeout_s=120)
            except Exception as exc:  # noqa: BLE001 - checked below
                prof["error"] = repr(exc)
            prof["window"] = (t0, time.monotonic_ns())

        def profile_run():
            try:
                prof["records"] = lg_p.run(workloads={"profiled": workloads["tenant-0"]})
            except Exception as exc:  # noqa: BLE001 - checked below
                prof["error"] = repr(exc)

        pt = threading.Thread(target=profile_keeper, daemon=True, name="fleet-d-profile")
        pl = threading.Thread(target=profile_run, daemon=True, name="fleet-d-profile-load")
        pt.start()
        pl.start()

        # -- (b) stateful, full width: 8 sessions, one worker drained -----------------
        out, errors = {}, []
        b1, b2 = threading.Barrier(FLEET_SESSIONS + 1), threading.Barrier(FLEET_SESSIONS + 1)

        def session(k):
            try:
                sock = socket_pair_client(r_b.port)
                ys = [query_request(query, sock, (prompts[k],), 0)]
                for i in range(FLEET_DRAIN_AT):
                    ys.append(query_request(query, sock, (steps[k][i],), i + 1))
                b1.wait(timeout=300)
                b2.wait(timeout=300)
                for i in range(FLEET_DRAIN_AT, FLEET_STEPS):
                    ys.append(query_request(query, sock, (steps[k][i],), i + 1))
                sock.close()
                out[k] = ys
            except BaseException as exc:  # noqa: BLE001 - reported below
                errors.append((k, repr(exc)))
                for b in (b1, b2):
                    b.abort()

        sess = [threading.Thread(target=session, args=(k,)) for k in range(FLEET_SESSIONS)]
        for t in sess:
            t.start()
        try:
            b1.wait(timeout=300)
        except threading.BrokenBarrierError:
            fail(f"fleet (b): sessions failed before the drain: {errors}")
        by_worker = r_b.stats()["sessions_by_worker"]
        drained = max(sorted(by_worker), key=lambda w: by_worker[w])
        n_drained = by_worker[drained]
        t_drain = spans.now_ns()
        broken = r_b.drain_worker(drained, deadline_s=60)
        try:
            b2.wait(timeout=300)
        except threading.BrokenBarrierError:
            fail(f"fleet (b): sessions failed at the drain: {errors}")
        for t in sess:
            t.join(timeout=300)
        check(not errors, f"fleet (b): session failures {errors}")
        err = max(float(np.abs(np.asarray(a).reshape(-1) - b.reshape(-1)).max() / np.abs(b).max())
                  for k in range(FLEET_SESSIONS) for a, b in zip(out[k], alone[k]))
        check(err <= DECODE_REL, f"fleet (b): a session is {err} of the largest from the "
                                 f"undisturbed engine's (tolerance {DECODE_REL})")
        st_b = r_b.stats()
        other = next(w for w in sorted(mw.wid for mw in sup_b.managed()) if w != drained)
        dec = {w: worker_stats(sup_b, w)["decode"] for w in (drained, other)}
        out_n, in_n = dec[drained]["sessions_migrated"], dec[other]["sessions_restored"]
        check(broken == 0 and st_b["sessions_broken"] == 0 and
              out_n == in_n == n_drained == st_b["sessions_migrated"],
              f"fleet (b): drained {drained} with {n_drained} sessions: broken {broken}, "
              f"migrated out {out_n}, in {in_n}, router {st_b['sessions_migrated']}")
        pauses = [r[2] for r in spans.snapshot()
                  if r[4] == "session_migrate" and r[1] >= t_drain]
        res["b"] = dict(sessions=FLEET_SESSIONS, prompt=FLEET_PROMPT, steps=FLEET_STEPS,
                        rel_err=err, drained=drained, migrated=n_drained,
                        longest_handoff_ms=max(pauses) / 1e6 if pauses else None)
        print(f"fleet (b): {FLEET_SESSIONS} sessions on 2 DecodeServer workers (capacity "
              f"{FLEET_CAPACITY}, d_model {FLEET_ENGINE['d_model']}, {FLEET_ENGINE['n_layers']} "
              f"layers), {drained} drained after {FLEET_DRAIN_AT} steps: {n_drained} sessions "
              f"migrated through the repo process, 0 broken, within {err:.3g} of the "
              f"undisturbed engine's; longest handoff {res['b']['longest_handoff_ms']} ms "
              f"[{card}]", flush=True)

        pl.join(timeout=180)
        pt.join(timeout=180)
        rec_p = prof.get("records", [])
        w0, w1 = prof.get("window", (0, 0))
        # the spans' clock is time.perf_counter_ns(): map the window onto it
        shift = spans.now_ns() - time.monotonic_ns()
        inside = [r for r in rec_p if r["status"] == "ok"
                  and w0 + shift <= r["t_done_ns"] <= w1 + shift]
        check(not prof.get("error") and prof.get("summary", {}).get("capture_id"),
              f"fleet (d): the worker's profile did not come back: {prof.get('error')}")
        check(rec_p and all(r["status"] == "ok" for r in rec_p) and inside,
              f"fleet (d): {keeper} stopped serving around its profile: {len(inside)} "
              f"replies inside the fetch, failures "
              f"{[r['code'] for r in rec_p if r['status'] != 'ok'][:5]}")
        summ = prof["summary"]
        res["profile"] = dict(worker=keeper, seconds=summ.get("seconds"),
                              stop_s=summ.get("stop_s"), ops_total=summ.get("ops_total"),
                              fetch_s=(w1 - w0) / 1e9, load=len(rec_p),
                              delivered_during=len(inside))
        print(f"fleet (d): {keeper}'s profile under {FLEET_PROFILE_RATE:g}/s of load: window "
              f"{summ.get('seconds')} s, stop {summ.get('stop_s')} s, {summ.get('ops_total')} "
              f"device ops, fetch {(w1 - w0) / 1e9:.3f} s with {len(inside)} replies "
              f"delivered inside it [{card}]", flush=True)

        # the victim: down, then respawned into up
        deadline = time.monotonic() + FLEET_JOIN_LIMIT_S
        while time.monotonic() < deadline and not (
                sup_a.get(victim).state == "up" and m_a.get(victim).state == "up"):
            time.sleep(0.05)
        prof["done_a"] = True
        bg.join(timeout=30)
        sm.join(timeout=30)
        states.append(m_a.get(victim).state)
        check("down" in states and states[-1] == "up",
              f"fleet (a): the killed worker's membership states {sorted(set(states))}, "
              f"last {states[-1]}")
        ev = [e for e in sup_a.events.snapshot() if e["worker"] == victim]
        t_resp = [e["t"] for e in ev if e["action"] == "respawn"]
        t_join = [e["t"] for e in ev if e["action"] == "join"]
        t_up = [e["t"] for e in ev if e["action"] == "spawn"]
        check(len(t_resp) == 1 and len(t_join) == 2 and len(t_up) == 2,
              f"fleet (a): the victim's scale events {[e['action'] for e in ev]}")
        respawn_s = t_join[-1] - t_resp[0]
        respawn_split = dict(process_up_s=t_up[-1] - t_resp[0], capture_s=t_join[-1] - t_up[-1])
        res["a"] = dict(rate=FLEET_RATE * FLEET_TENANTS, tenants=FLEET_TENANTS,
                        requests=len(records), replies_exact=len(ok),
                        p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"], rerouted=st_a["rerouted"],
                        killed=victim, respawn_to_routable_s=respawn_s, **respawn_split,
                        membership_states=sorted(set(states)))
        print(f"fleet (a): {len(records)} requests at {FLEET_RATE * FLEET_TENANTS:g}/s open "
              f"loop from {FLEET_TENANTS} tenants through the router, {victim} killed by the "
              f"seeded chaos: every reply bitwise the in-process slice's, offered "
              f"{st_a['offered']} = delivered {st_a['delivered']} + shed 0, rerouted "
              f"{st_a['rerouted']}; client p50 {lat['p50_ms']:.3f} ms, p99 "
              f"{lat['p99_ms']:.3f} ms from the scheduled arrival; respawn to routable "
              f"{respawn_s:.3f} s (process up {respawn_split['process_up_s']:.3f} s, then "
              f"warmup capture {respawn_split['capture_s']:.3f} s) [{card}]", flush=True)

        # -- (d) the merged trace, cost models, forensics and the SLO burn ---------
        live_a = {w: sup_a.get(w).handle.ports["health_addr"] for w in wids}
        tc = col.TraceCollector()
        tc.add_local("chip_smoke")
        for w, addr in live_a.items():
            tc.add_http(w, addr)
        collected = tc.collect()
        offsets = {n: e["rtt_ns"] for n, e in collected["sources"].items()}
        chains = fleet_chain(tc.spans_by_trace(collected), offsets)
        check(chains, "fleet (d): no trace id runs client -> nnsq_route -> nnsq_serve -> "
                      f"device_exec with aligned clocks (errors {collected['errors']})")
        slo = SloEngine(objectives=FLEET_D_SLO, eval_interval_s=0.0)
        fengine = ForensicsEngine(pipeline="fleet", cost_model={"schema": 1, "stages": {}},
                                  min_samples=FLEET_D_MIN_SAMPLES)
        before = r_a.stats()
        lg_d = loadgen.LoadGen(("127.0.0.1", r_a.port),
                               [dict(name="burst", workload="slice1",
                                     profile=dict(kind="constant", rate=FLEET_D_RATE))],
                               FLEET_D_SECONDS, seed=22, metric_pipeline="fleet-d")
        rec_d = lg_d.run(workloads={"burst": workloads["tenant-0"]})
        tc_d = col.TraceCollector()
        tc_d.add_local("chip_smoke")
        for w, addr in live_a.items():
            tc_d.add_http(w, addr)
        report = loadgen.build_report(rec_d, FLEET_D_SECONDS, lg_d.t0_ns, [], 22,
                                      scenario="fleet-d", collector=tc_d,
                                      forensics_engine=fengine)
        verdicts = fengine.summary()["outliers"]
        docs = {w: col.http_get_json(f"http://{addr}/alerts", 30) for w, addr in live_a.items()}
        docs["chip_smoke"] = slo.alerts_document(force=True)
        merged = col.merge_alerts(docs)
        after = r_a.stats()
        check(all(r["status"] == "ok" for r in rec_d)
              and after["delivered"] - before["delivered"] == len(rec_d)
              and after["shed_total"] == before["shed_total"],
              f"fleet (d): the burst lost requests: {[r['code'] for r in rec_d if r['status'] != 'ok'][:5]}")
        check(verdicts.get("device", 0) > 0,
              f"fleet (d): invoke_delay gave no device verdict: {verdicts}")
        check("fleet" in merged["firing"],
              f"fleet (d): merge_alerts shows no burn: {merged['objectives'].get('fleet')}")
        cms = {}
        for w in live_a:
            st = worker_stats(sup_a, w)
            check(not fleet_replay_check(w, st),
                  f"fleet (d): {w} after the burst: {fleet_replay_check(w, st)}")
            cms[w] = {p: sorted(s["stages"]) for p, s in st.get("cost_model", {}).items()}
            check(any(s["stages"] for s in st.get("cost_model", {}).values()),
                  f"fleet (d): {w}'s cost model is empty")
        burn = {k: v["burn"] for k, v in merged["objectives"]["fleet"]["windows"].items()}
        res["d"] = dict(trace_chains=len(chains), clock_rtt_us={n: v / 1e3 for n, v in offsets.items()},
                        cost_model_stages=cms, burst=len(rec_d), verdicts=verdicts,
                        joined=report["attribution"]["joined"], burn=burn)
        print(f"fleet (d): {len(chains)} trace ids run client -> nnsq_route -> nnsq_serve -> "
              f"device_exec across {len(collected['sources'])} processes, clocks aligned "
              f"(probe rtt us {res['d']['clock_rtt_us']}); cost models {cms}; a burst of "
              f"{len(rec_d)} with invoke_delay on {victim}'s respawn: verdicts {verdicts}, "
              f"merged SLO burn {burn} firing {merged['firing']} [{card}]", flush=True)

        # -- (c) elastic: the autoscaler takes the fleet 1 -> 2 -> 1 on a spike --------
        # the spike ends long before the scale-up's worker is routable: the
        # scale-down cancels that joining worker and the floor, the one
        # routable worker, serves on (ROADMAP C21)
        dur = FLEET_C_PRE_S + FLEET_C_SPIKE_S + FLEET_C_POST_S
        n_before = len(sup_c.events.snapshot())
        (floor_c,) = [mw.wid for mw in sup_c.managed()]
        router_signals = RouterSignals(r_c, m_c, registry=MetricsRegistry())
        readings = []  # (seconds into the load, offered requests/s) a tick
        floor_states = []
        t_load = [time.monotonic()]

        def signals():
            sig = router_signals()
            readings.append((round(time.monotonic() - t_load[0], 3), round(sig.offered_rps, 3)))
            return sig

        def sample_floor():
            while not stop_evt.is_set() and not prof.get("done_c"):
                floor_states.append((m_c.get(floor_c).state, sup_c.get(floor_c).state))
                time.sleep(0.01)

        autoscaler = Autoscaler(
            sup_c, signals, name="fleet-c",
            min_workers=1, max_workers=2, interval_s=1.0, worker_rps=FLEET_C_WORKER_RPS,
            forecast=True, forecast_horizon_s=1.0, history_window_s=FLEET_C_HISTORY_S,
            up_cooldown_s=1.0, down_cooldown_s=2.0).start()
        lg_c = loadgen.LoadGen(("127.0.0.1", r_c.port),
                               [dict(name="spiky", workload="slice1",
                                     profile=dict(kind="spike", rate=FLEET_C_BASE,
                                                  peak=FLEET_C_PEAK,
                                                  at=(FLEET_C_PRE_S + FLEET_C_SPIKE_S / 2) / dur,
                                                  width=FLEET_C_SPIKE_S / dur))],
                               dur, seed=23, metric_pipeline="fleet-c")
        sf = threading.Thread(target=sample_floor, daemon=True, name="fleet-c-floor")
        t_load[0] = time.monotonic()
        sf.start()
        rec_c = lg_c.run(workloads={"spiky": workloads["tenant-0"]})
        # the drain: the router's, then SIGTERM and the process's exit
        deadline = time.monotonic() + 2 * FLEET_EXIT_LIMIT_S
        drained_c = t_exit = None
        while time.monotonic() < deadline:
            ev = sup_c.events.snapshot()[n_before:]
            drains = [e for e in ev if e["action"] == "drain"]
            if drains:
                h = sup_c.get(drains[0]["worker"]).handle
                if t_exit is None and h.proc.poll() is not None:
                    t_exit = time.monotonic() - drains[0]["t"]
                if sup_c.get(drains[0]["worker"]).state == "removed":
                    drained_c = drains[0]["worker"]
                    break
            time.sleep(0.05)
        autoscaler.stop()
        prof["done_c"] = True
        sf.join(timeout=30)
        ev = sup_c.events.snapshot()[n_before:]
        acts = [(e["action"], e["worker"]) for e in ev]
        spawned = [w for a, w in acts if a == "spawn"]
        check([a for a, _ in acts].count("spawn") == 1 and [a for a, _ in acts].count("drain") == 1
              and drained_c is not None and spawned == [drained_c]
              and ("join", drained_c) not in acts
              and ev[[a for a, _ in acts].index("drain")]["detail"].endswith(
                  "cancelled while joining"),
              f"fleet (c): scale events {[(e['action'], e['worker'], e['detail']) for e in ev]}: "
              "the scale-down must cancel the joining worker")
        st_sup = sup_c.stats()
        check(floor_states and all(m in ("up", "degraded") and s_ == "up"
                                   for m, s_ in floor_states)
              and st_sup["cancelled"] == 1 and st_sup["ledger_exact"],
              f"fleet (c): the floor {floor_c} left rotation ({sorted(set(floor_states))}) or "
              f"the spawn ledger is off ({ {k: st_sup[k] for k in ('spawns', 'joined', 'cancelled', 'ledger_exact')} })")
        rc = sup_c.get(drained_c).handle.proc.returncode
        st_c = r_c.stats()
        check(rc == 0, f"fleet (c): the drained worker {drained_c} exited with {rc}")
        check(all(r["status"] == "ok" for r in rec_c) and st_c["shed_total"] == 0
              and st_c["offered"] == st_c["delivered"] == len(rec_c),
              f"fleet (c): requests lost: router {st_c['offered']} offered, "
              f"{st_c['delivered']} delivered, shed {st_c['shed']}; client "
              f"{[r['code'] for r in rec_c if r['status'] != 'ok'][:5]}")
        t_spawn_c = next(e["t"] for e in ev if e["action"] == "spawn")
        t_drain_c = next(e["t"] for e in ev if e["action"] == "drain")
        # events and the controller's load readings in seconds into the load;
        # the spike runs from FLEET_C_PRE_S to FLEET_C_PRE_S + FLEET_C_SPIKE_S
        res["c"] = dict(requests=len(rec_c), base=FLEET_C_BASE, peak=FLEET_C_PEAK,
                        spike_s=FLEET_C_SPIKE_S, worker_rps=FLEET_C_WORKER_RPS,
                        spike=(FLEET_C_PRE_S, FLEET_C_PRE_S + FLEET_C_SPIKE_S),
                        events=[(e["action"], e["worker"], round(e["t"] - t_load[0], 3),
                                 e["detail"]) for e in ev],
                        readings=readings, spawn_to_cancel_s=t_drain_c - t_spawn_c,
                        drained_rc=rc, drain_to_exit_s=t_exit,
                        fleet=(autoscaler.fleet_size_min, autoscaler.fleet_size_max))
        print(f"fleet (c): spike {FLEET_C_BASE:g} -> {FLEET_C_PEAK:g} -> {FLEET_C_BASE:g}/s "
              f"({len(rec_c)} requests, none lost), the spike over {res['c']['spike']} s into "
              f"the load: scale events {res['c']['events']}; the scale-up's worker cancelled "
              f"while joining {t_drain_c - t_spawn_c:.3f} s after its spawn, the floor "
              f"{floor_c} routable throughout ({len(floor_states)} samples); the drained "
              f"worker exited 0, {t_exit:.3f} s after its drain began [{card}]", flush=True)
        print(f"fleet (c): the controller's load readings (s, requests/s) {readings}",
              flush=True)
    except BaseException:
        fleet_log_tails(logs)
        raise
    finally:
        stop_evt.set()
        hooks.disconnect("scale_event", on_scale)
        if autoscaler is not None:
            autoscaler.stop()
        faults.deactivate()
        for sup in sups:
            for mw in sup.managed():
                if mw.handle is not None:
                    mw.handle.kill()
                    try:
                        mw.handle.proc.wait(timeout=30)
                    except Exception:  # noqa: BLE001 - killed; reaped by the OS
                        pass
        if repo_proc is not None:
            repo_proc.kill()
            repo_proc.wait(timeout=30)
        for r in (r_a, r_b, r_c):
            if r is not None:
                r.stop()
        for m in (m_a, m_b, m_c):
            m.stop()
        if not was_spans:
            spans.disable()
        for f in files:
            f.close()
    check(all(tally[k] > 0 for k in ("fused_arith", "int8_matmul")),
          f"fleet: the workers' kernel launches {tally}: fused_arith and int8_matmul must run")
    check(not fleet_join_check(handles_seen),
          f"fleet: launch counts at the joins: {fleet_join_check(handles_seen)}")
    res["launches_by_worker"] = handles_seen
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"fleet: kernel launches in the workers {tally} ({len(handles_seen)} worker "
          f"incarnations); phase wall {res['wall_s']:.3f} s [{card}]", flush=True)
    return tally, res


# -- placement, the native queue, the autotune cache, the soak ------------------------

PART_FRAMES = 64           # (a): slice 1's frames through each placement
PART_CUT = 5               # the filter's index in PART_DESC: the server fragment is the filter
PART_JOIN_LIMIT_S = 180    # the fragment worker's spawn (import, model build, capture) to "ok"
PART_LOGIT_REL = 1e-3      # the worker's graph (the model) against the in-process one (the
                           # normalize folded in): a conv algorithm picked differently
PART_FAST = {"put_150k_ms": 0.5, "dispatch_ms": 0.2}   # the edge records the monitor reads
PART_SLOW = {"put_150k_ms": 50.0, "dispatch_ms": 5.0}
LEAK_FRAMES = 12           # (b): frames pushed behind a stalled consumer ...
LEAK_CAPACITY = 4          # ... into a queue of this many
AUTOTUNE_SHAPES = ((1, 1280, 1001), (32, 1280, 1001))  # (c): the head and a batch of 32
AUTOTUNE_REPS = 200
SOAK_SECONDS = 40          # (d): the campaign's wall-time bound
SOAK_BASE_SEED = 22
SOAK_LIMIT_S = 150         # the subprocess's hard limit (import, CUDA start, campaign)


def part_desc(ckpt, n=None):
    """Slice 1's launch string with its model from a checkpoint (so that a
    worker process can load it) and the logits at the sink: the decoder's
    label travels in a frame's meta, which NNSQ does not carry, so the
    labels are the decoder's rule (the argmax, lowest index on ties) on the
    logits."""
    n = PART_FRAMES if n is None else n
    return (f"videotestsrc name=src num-buffers={n} width={IMAGE} height={IMAGE} "
            "pattern=random seed=7 ! tensor_converter name=conv ! "
            f"tensor_transform name=norm mode=arithmetic option={NORMALIZE} acceleration=pallas ! "
            "tensor_upload name=u ! queue name=q max-size-buffers=16 ! "
            f"tensor_filter framework=torch name=f model={ckpt} "
            f"custom=builder=mobilenet_v2:build_quantized,int8_head=1,image_size={IMAGE},"
            f"num_classes={CLASSES} ! tensor_sink name=out")


def force_cut(plan, cut):
    """``plan`` with its cut forced to ``cut`` (its score from the plan's own
    scan), as the reference's deployment test forces a split the planner
    would not take on this edge."""
    import dataclasses

    return dataclasses.replace(plan, cut=cut, chosen=plan.score_for(cut))


def labels_of(np, logits):
    """The image_labeling decoder's rule: the argmax, lowest index on ties."""
    return [int(np.argmax(np.asarray(x).reshape(-1))) for x in logits]


def partition_check(ref, got, offered, delivered, client, worker):
    """A split run against the in-process run: labels, the frame ledger, and
    each process's kernel launches (the client's normalize once a frame, the
    worker's ``int8_matmul`` in its warmup capture only, its requests
    replayed).  Returns the faults found."""
    bad = []
    if delivered != offered:
        bad.append(f"delivered {delivered} of {offered} offered")
    if got != ref:
        diff = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
        bad.append(f"labels differ from the in-process run at frames {diff[:8]} "
                   f"({len(got)} against {len(ref)})")
    if client.get("fused_arith") != offered or client.get("int8_matmul") != 0:
        bad.append(f"client launches {client}: fused_arith once a frame ({offered}), "
                   "int8_matmul never")
    if worker.get("int8_matmul") != FLEET_CAPTURE_CALLS["int8_matmul"] or \
            worker.get("fused_arith") != 0:
        bad.append(f"worker launches {worker}: int8_matmul "
                   f"{FLEET_CAPTURE_CALLS['int8_matmul']} (its capture), fused_arith never")
    return bad


def leak_expect(mode, n=LEAK_FRAMES, cap=LEAK_CAPACITY):
    """What a queue of ``cap`` delivers of frames 0..n-1 when its consumer
    holds frame 0 while the rest are pushed: ``(pts delivered, drops)``."""
    if mode == "downstream":   # the oldest queued frame makes room
        return [0] + list(range(n - cap, n)), n - 1 - cap
    if mode == "upstream":     # the incoming frame is refused
        return list(range(cap + 1)), n - 1 - cap
    return list(range(n)), 0   # "no": the producer waits


def soak_verdict(rc, stdout):
    """The soak campaign's last line (a JSON object) read against its
    verdict: ``(result or None, faults)``; it passes only with no failed
    seed, no lock-order cycle and lockdep installed."""
    lines = [ln for ln in (stdout or "").strip().splitlines() if ln.strip()]
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        return None, [f"no result line (exit {rc})"]
    bad = []
    if rc != 0:
        bad.append(f"exit {rc}")
    if res.get("failures"):
        bad.append(f"{res['failures']} failed seeds {res.get('failed_seeds')}")
    if res.get("iterations", 0) < 1:
        bad.append("no iteration ran")
    lk = res.get("lockdep") or {}
    if not lk.get("installed"):
        bad.append("lockdep was not installed")
    elif lk.get("cycles"):
        bad.append(f"{lk['cycles']} lock-order cycles")
    return res, bad


def partition_phase(torch, np, K, root, card):
    """Phase 32 (a): slice 1 at full width planned, split and re-partitioned
    across a fragment worker process (``partition/``).  The in-process run
    under the device and cost-model tracers fills a COST_MODEL.json in a temp
    dir and gives the reference labels; the planner prices the cuts (an
    unprobed edge is never chosen); a deployment with the cut forced at the
    filter (normalize on this side, the int8 head in the worker) spawns the
    worker, warming-gated, and ``register_edge`` probes the real NNSQ edge;
    the planner runs again on the measured edge; 64 frames through the split
    must give the in-process labels, every frame delivered, each kernel
    launching in its process; a slow record for the edge flips its regime
    and ``RepartitionMonitor`` redeploys once, all-local, through the
    worker's drain (it exits 0); the stream goes on all-local with the same
    labels."""
    import tempfile

    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.obs import util as obs_util
    from nnstreamer_tpu_torch.obs.costmodel import load_cost_model, stage_key
    from nnstreamer_tpu_torch.partition import (PartitionDeployment, RepartitionMonitor,
                                                card_peaks, plan_partition,
                                                subproc_worker_factory)
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec
    from nnstreamer_tpu_torch.utils.checkpoint import save_state

    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="partition_", dir=work)
    ckpt = os.path.join(tmp, "mobilenet_v2.npz")
    save_state(mobilenet_v2.init_tree(0, CLASSES, 1.0), ckpt)
    desc = part_desc(ckpt)
    cm_path = os.path.join(tmp, "COST_MODEL.json")
    saved_cm = os.environ.get("NNSTPU_OBS_COSTMODEL_PATH")
    os.environ["NNSTPU_OBS_COSTMODEL_PATH"] = cm_path
    name = "slice1"
    gpu = torch.cuda.get_device_name(0)
    peaks = card_peaks(gpu, gpu)
    res = {"peaks": peaks}
    log_path = os.path.join(tmp, "worker.log")
    log = open(log_path, "w", encoding="utf-8")
    dep = None

    def run(launch, tracers=()):
        got = []
        p = nns.parse_launch(launch)
        p.name = name
        for t in tracers:
            p.attach_tracer(t)
        p["out"].connect("new-data", lambda f: got.append(f.tensor(0).float().cpu().numpy()))
        t0 = time.perf_counter()
        p.run(timeout=600)
        return p, got, time.perf_counter() - t0

    try:
        # 1. in-process, under the cost-model tracer: the reference and the costs
        _, ref_logits, ref_s = run(desc, tracers=("device", "costmodel"))
        check(len(ref_logits) == PART_FRAMES,
              f"partition: the in-process run delivered {len(ref_logits)} of {PART_FRAMES}")
        ref = labels_of(np, ref_logits)
        cm = load_cost_model(cm_path)
        # the planner prices one (bucket, mesh): the filter's, which both
        # packages key by its input's leading dim (224 for a frame)
        f_keys = [k for k in cm["stages"] if k.split("|")[:2] == [name, "f"]]
        check(len(f_keys) == 1, f"partition: COST_MODEL.json filter stages {f_keys}")
        bucket = int(f_keys[0].split("|")[2][1:])
        mesh = int(f_keys[0].split("|")[3][4:])
        f_entry = cm["stages"][stage_key(name, "f", bucket, mesh)]
        check("device_exec" in (f_entry.get("legs") or {}),
              f"partition: COST_MODEL.json has no device leg for the filter: {f_entry}")
        print(f"partition: in-process slice 1, {PART_FRAMES} frames in {ref_s:.3f} s, "
              f"{len(set(ref))} distinct labels; COST_MODEL.json stages "
              f"{sorted(k.split('|')[1] for k in cm['stages'])}, the filter "
              f"{ {leg: round(v['mean_us'], 3) for leg, v in f_entry['legs'].items()} } us",
              flush=True)

        # 2. the unprobed edge, then the forced split, warming-gated
        plan0 = plan_partition(desc, pipeline=name, addr="unprobed", edge="edge0",
                               cost_model=cm, bucket=bucket, mesh=mesh, peaks=peaks)
        check(plan0.cut is None, f"partition: an unprobed edge was chosen: cut {plan0.cut}")
        env = dict(os.environ)
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                    else "")
        env["NNSTPU_OBS_COSTMODEL_PATH"] = os.path.join(tmp, "worker_COST_MODEL.json")
        env.pop("NNSTPU_FAULTS", None)
        t0 = time.perf_counter()
        dep = PartitionDeployment(
            force_cut(plan0, PART_CUT), warm_timeout_s=PART_JOIN_LIMIT_S,
            client_props={"request_timeout": "60"},
            worker_factory=subproc_worker_factory(
                device=DEVICE, warmup_spec=f"float32:{IMAGE}x{IMAGE}x3", env=env, stderr=log,
                line_timeout_s=PART_JOIN_LIMIT_S)).start()
        res["worker_ok_s"] = time.perf_counter() - t0
        worker = dep.worker
        measured = dep.register_edge(TensorsSpec.of(TensorSpec(dtype=np.float32,
                                                               shape=(IMAGE, IMAGE, 3))))
        res["edge"] = {k: measured[k] for k in ("put_150k_ms", "dispatch_ms", "regime")}
        print(f"partition: fragment worker pid {worker.pid} at {dep.addr} servable "
              f"{res['worker_ok_s']:.3f} s after its spawn (warming-gated); edge probe "
              f"{res['edge']} [{card}]", flush=True)
        plan1 = plan_partition(desc, pipeline=name, addr=dep.addr, edge="edge0",
                               cost_model=cm, bucket=bucket, mesh=mesh, peaks=peaks)
        res["plan"] = plan1.to_dict()
        print(f"partition: plan on the measured edge: cut {plan1.cut}, regime {plan1.regime}, "
              f"fingerprint {plan1.fingerprint}", flush=True)
        for s in plan1.scores:
            print(f"  cut {s.cut}: total {s.total_us} us = client {s.client_us} + server "
                  f"{s.server_us} + transfer {s.transfer_us}", flush=True)
        if plan1.cut != PART_CUT:
            print(f"partition: one card on loopback, the planner keeps cut {plan1.cut}; the "
                  f"split is forced at cut {PART_CUT} (the filter), as the reference's "
                  f"deployment test forces it", flush=True)
        dep.plan = force_cut(plan1, PART_CUT)

        # 3. the split: 64 frames, each kernel in its own process
        launch = dep.client_launch()
        check("tensor_query_client" in launch and launch.count("tensor_filter") == 0,
              f"partition: the client half holds the filter: {launch}")
        K.reset_launches()
        p, got_logits, split_s = run(launch)
        client = {k.__name__: k.launches for k in K.KERNELS}
        st = worker.stats()
        worker_counts = dict(st["kernels"])
        rtt = p[f"qc_{dep.plan.edge}"].rtt_ns
        got = labels_of(np, got_logits)
        for fault in partition_check(ref, got, PART_FRAMES, len(got_logits), client,
                                     worker_counts):
            fail(f"partition (split): {fault}")
        rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                  for a, b in zip(got_logits, ref_logits))
        check(rel <= PART_LOGIT_REL, f"partition: split logits {rel} (relative) from the "
                                     f"in-process run's")
        g = st["query"]["graphs"]
        check(g["captures"] == 1 and g["replays"] >= PART_FRAMES,
              f"partition: the worker's graphs {g}: one capture, a replay a frame")
        res.update(split_fps=PART_FRAMES / split_s, split_logit_rel=rel,
                   rtt_p50_ms=float(np.percentile(np.asarray(rtt) / 1e6, 50)) if rtt else None,
                   client_launches=client, worker_launches=worker_counts,
                   worker_graphs=g)
        print(f"partition: split run, {PART_FRAMES} of {PART_FRAMES} frames, labels equal to "
              f"the in-process run's, logits within {rel:.3g}; {res['split_fps']:.3f} fps, "
              f"round trip p50 {res['rtt_p50_ms']} ms; launches client {client}, worker "
              f"{worker_counts}, worker graphs {g} [{card}]", flush=True)

        # 4. the regime flip: exactly one redeploy, all-local, the worker drained
        obs_util.publish_wire_health(dict(PART_FAST), addr=dep.addr)
        dep.plan = force_cut(plan_partition(desc, pipeline=name, addr=dep.addr, edge="edge0",
                                            cost_model=cm, bucket=bucket, mesh=mesh,
                                            peaks=peaks), PART_CUT)
        mon = RepartitionMonitor(dep, peaks=peaks)
        check(mon.evaluate_once() is None, "partition: the monitor acted on a steady edge")
        obs_util.publish_wire_health(dict(PART_SLOW), addr=dep.addr)
        t0 = time.perf_counter()
        reason = mon.evaluate_once()
        res["redeploy_s"] = time.perf_counter() - t0
        check(reason is not None and "regime flip" in reason,
              f"partition: no regime-flip trigger: {reason}")
        check(dep.redeploys == 1 and dep.worker is None and dep.plan.cut is None,
              f"partition: after the flip: {dep.redeploys} redeploys, cut {dep.plan.cut}")
        check(worker.returncode == 0, f"partition: the drained worker exited {worker.returncode}")
        check(mon.evaluate_once() is None and mon.triggers == 1,
              f"partition: {mon.triggers} triggers after the flip")
        print(f"partition: {reason}; one redeploy, all-local, the worker drained and out with "
              f"0 in {res['redeploy_s']:.3f} s", flush=True)

        # 5. the stream goes on, all-local
        K.reset_launches()
        _, local_logits, local_s = run(dep.client_launch())
        local = {k.__name__: k.launches for k in K.KERNELS}
        check(len(local_logits) == PART_FRAMES and labels_of(np, local_logits) == ref,
              "partition: the all-local run after the redeploy differs from the in-process run")
        res.update(local_fps=PART_FRAMES / local_s, local_launches=local)
        print(f"partition: all-local after the redeploy, {PART_FRAMES} of {PART_FRAMES} "
              f"frames, labels equal; launches {local}", flush=True)
    except BaseException:
        log.flush()
        fleet_log_tails([log_path])
        raise
    finally:
        if dep is not None:
            dep.stop(drain=False)
        log.close()
        if saved_cm is None:
            os.environ.pop("NNSTPU_OBS_COSTMODEL_PATH", None)
        else:
            os.environ["NNSTPU_OBS_COSTMODEL_PATH"] = saved_cm
    res["wall_s"] = time.perf_counter() - t_phase
    return {"partition_client": (client, res), "partition_worker": (worker_counts, {}),
            "partition_local": (local, {})}


def leak_run(nns, mode):
    """Frames 0..LEAK_FRAMES-1 through ``appsrc ! queue leaky=<mode> !
    tensor_sink`` whose consumer holds frame 0 until every frame is pushed:
    ``(pts delivered, the queue's stats, its drops when the pushes were
    done)``; the EOS goes into the full queue after them and must arrive."""
    import threading

    import torch

    from nnstreamer_tpu_torch.buffer import Frame
    from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

    entered, release = threading.Event(), threading.Event()
    got = []
    p = nns.parse_launch(f"appsrc name=src ! queue name=q leaky={mode} "
                         f"max-size-buffers={LEAK_CAPACITY} ! tensor_sink name=out")
    p["src"].set_spec(TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(4,))))

    def on_frame(f):
        got.append(f.pts)
        if f.pts == 0:
            entered.set()
            release.wait(60)

    p["out"].connect("new-data", on_frame)
    p.start()
    try:
        q = p["q"]
        impl = q.stats()["impl"]
        p["src"].push_frame(Frame.of(torch.ones(4), pts=0))
        check(entered.wait(30), f"leak {mode}: the consumer never took frame 0")
        for i in range(1, LEAK_FRAMES):
            p["src"].push_frame(Frame.of(torch.ones(4), pts=i))
        # settled: the queue full, the leaky modes' drops done; with "no" the
        # source's thread waits on frame cap+1, the rest still in the appsrc
        want_drops = leak_expect(mode)[1]
        want_backlog = LEAK_FRAMES - 2 - LEAK_CAPACITY if mode == "no" else 0
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = q.stats()
            if st["depth"] == LEAK_CAPACITY and st["dropped"] == want_drops and \
                    p["src"]._q.qsize() == want_backlog:
                break
            time.sleep(0.01)
        drops = q.stats()["dropped"]
        p["src"].end_of_stream()
        time.sleep(0.05)
        release.set()
        check(p.wait(60), f"leak {mode}: the EOS never arrived")
        return got, dict(q.stats(), impl=impl), drops
    finally:
        release.set()
        p.stop()


def native_queue_phase(torch, np, K, root, card, keep):
    """Phase 33 (b): the C++ frame queue behind ``queue``.  Slice 1 through
    its launch string on the native queue (``[common] native_runtime`` on,
    the default) and again on the Python twin (``native_runtime=off``): the
    queue element names its queue in ``stats()["impl"]``, and the labels
    must be equal; then each leak mode under a stalled consumer: the drops
    and the frames delivered as a queue of LEAK_CAPACITY must give them, the
    EOS kept."""
    import nnstreamer_tpu_torch as nns
    from nnstreamer_tpu_torch import native

    t_phase = time.perf_counter()
    desc, model = keep["image_labeling"][:2]
    res = {"library": str(native.lib_path().relative_to(root))}
    runs = {}
    saved = os.environ.get("NNSTPU_COMMON_NATIVE_RUNTIME")
    try:
        for setting, want in (("on", "native"), ("off", "python")):
            os.environ["NNSTPU_COMMON_NATIVE_RUNTIME"] = setting
            seen = {}

            def during(p, seen=seen):
                qs = [n for n in p.nodes.values() if type(n).__name__ == "Queue"]
                seen["impl"] = [q.stats()["impl"] for q in qs]
                seen["launches"] = {k.__name__: k.launches for k in K.KERNELS}

            K.reset_launches()
            p, arrivals, _ = run_pipeline(nns, desc(FRAMES), model, FRAMES, during=during)
            check(seen["impl"] == [want],
                  f"native queue ({setting}): the queue runs {seen['impl']}, not {want}")
            runs[want] = dict(labels=[f.meta["label_index"] for f in p["out"].frames],
                              launches=seen["launches"], **rates(arrivals, np))
        check(runs["native"]["labels"] == runs["python"]["labels"],
              "native queue: slice 1's labels differ between the native queue and the twin")
        os.environ["NNSTPU_COMMON_NATIVE_RUNTIME"] = "on"
        leaks = {}
        for mode in ("downstream", "upstream", "no"):
            got, st, drops = leak_run(nns, mode)
            want_pts, want_drops = leak_expect(mode)
            check(st["impl"] == "native", f"leak {mode}: the queue runs {st['impl']}")
            check(got == want_pts and drops == want_drops == st["dropped"],
                  f"leak {mode}: delivered {got}, {drops} drops; want {want_pts}, {want_drops}")
            leaks[mode] = dict(delivered=len(got), dropped=drops)
    finally:
        if saved is None:
            os.environ.pop("NNSTPU_COMMON_NATIVE_RUNTIME", None)
        else:
            os.environ["NNSTPU_COMMON_NATIVE_RUNTIME"] = saved
    res.update(native_fps=runs["native"]["fps"], twin_fps=runs["python"]["fps"],
               native_p50_gap_ms=runs["native"]["p50_ms"],
               twin_p50_gap_ms=runs["python"]["p50_ms"], leak=leaks,
               wall_s=time.perf_counter() - t_phase)
    print(f"native queue: slice 1 on the C++ queue {res['native_fps']:.3f} fps (p50 gap "
          f"{res['native_p50_gap_ms']:.3f} ms), on the Python twin {res['twin_fps']:.3f} fps "
          f"(p50 gap {res['twin_p50_gap_ms']:.3f} ms), labels equal; leak modes behind a "
          f"stalled consumer {leaks}, the EOS kept [{card}]", flush=True)
    return {"native_queue": (runs["native"]["launches"], res),
            "native_twin": (runs["python"]["launches"], {})}


def autotune_phase(torch, np, K, root, card):
    """Phase 34 (c): ``ops/autotune.py`` for ``int8_matmul``.  At the head's
    shape and a batch of 32 the search launches every geometry the kernel
    takes (split-K clusters of 1, 2, 4 and 8 blocks, the tiled branch), each
    bitwise against the plain version, times each, and records the fastest
    in a temp cache dir; a fresh consult gives the winner's geometry and a
    call at it is bitwise the plain version; with no cache the default
    geometry holds."""
    import tempfile

    from nnstreamer_tpu_torch.ops import autotune

    t_phase = time.perf_counter()
    cache = tempfile.mkdtemp(prefix="autotune_", dir=os.path.join(root, "build", "chip_smoke"))
    saved = os.environ.get("NNSTPU_COMPILE_CACHE_DIR")
    gpu = torch.cuda.get_device_name(0)
    out = {}
    try:
        os.environ["NNSTPU_COMPILE_CACHE_DIR"] = cache
        autotune.refresh()
        for m, k, n in AUTOTUNE_SHAPES:
            r = autotune.autotune_int8_matmul(m, k, n, reps=AUTOTUNE_REPS)
            check(all(c["bitwise"] for c in r["candidates"]) and r["recorded"],
                  f"autotune ({m},{k},{n}): {r}")
            for c in r["candidates"]:
                print(f"autotune ({m},{k},{n}) {c['config']} grid {c['geometry'][2]}: "
                      f"{c['ms']:.6f} ms, bitwise [{card}]", flush=True)
            out[f"{m}x{k}x{n}"] = dict(winner=r["winner"], ms=r["ms"],
                                       candidates=[dict(config=c["config"], ms=c["ms"])
                                                   for c in r["candidates"]])
        path = os.path.join(cache, "autotune", "int8_matmul.json")
        check(os.path.exists(path), f"autotune: no cache file at {path}")
        autotune.refresh()
        rng = np.random.default_rng(34)
        for m, k, n in AUTOTUNE_SHAPES:
            want = autotune.geometry_of(out[f"{m}x{k}x{n}"]["winner"], m, k, n)
            geo = K.int8_matmul_geometry(m, k, n, gpu)
            check(geo == want, f"autotune ({m},{k},{n}): the consult gives {geo}, not {want}")
            xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).cuda()
            wq = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).cuda()
            xs = torch.tensor(np.float32(0.01), device="cuda")
            ws = torch.from_numpy((rng.random(n) * 0.01 + 1e-4).astype(np.float32)).cuda()
            b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
            got = K.int8_matmul(xq, wq, xs, ws, b)
            check(bitwise_equal(torch, got, K.int8_matmul_plain(xq, wq, xs, ws, b)),
                  f"autotune ({m},{k},{n}): a call at the tuned geometry differs from plain")
            out[f"{m}x{k}x{n}"]["consulted"] = list(geo)
            print(f"autotune ({m},{k},{n}): a fresh consult gives {tuple(geo)} (the winner), "
                  f"its call bitwise the plain version", flush=True)
        os.environ.pop("NNSTPU_COMPILE_CACHE_DIR")
        autotune.refresh()
        for (m, k, n), want in zip(AUTOTUNE_SHAPES, (K.splitk_geometry(1, 1280, 1001),
                                                    K.tiled_geometry(32, 1280, 1001))):
            geo = K.int8_matmul_geometry(m, k, n, gpu)
            check(geo == want, f"autotune: with no cache ({m},{k},{n}) gives {geo}, not {want}")
        print(f"autotune: with no cache the default geometry holds: "
              f"{[tuple(K.int8_matmul_geometry(*s, gpu)) for s in AUTOTUNE_SHAPES]}", flush=True)
    finally:
        if saved is None:
            os.environ.pop("NNSTPU_COMPILE_CACHE_DIR", None)
        else:
            os.environ["NNSTPU_COMPILE_CACHE_DIR"] = saved
        autotune.refresh()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def soak_phase(root, card):
    """Phase 35 (d): ``tools/soak_campaign.py --lockdep`` on the card in a
    subprocess, seeds from SOAK_BASE_SEED for SOAK_SECONDS: every frame of
    every template exact, and no lock-order cycle in the port's locks."""
    t_phase = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.pop("NNSTPU_FAULTS", None)
    cmd = [sys.executable, "-m", "nnstreamer_tpu_torch.tools.soak_campaign",
           "--base-seed", str(SOAK_BASE_SEED), "--minutes", str(SOAK_SECONDS / 60),
           "--device", DEVICE, "--lockdep"]
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=SOAK_LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        fail(f"soak: the campaign ran past {SOAK_LIMIT_S} s: {stdout[-2000:]}{stderr[-2000:]}")
    res, bad = soak_verdict(proc.returncode, stdout)
    if bad:
        print(stdout[-6000:], file=sys.stderr)
        print(stderr[-4000:], file=sys.stderr)
        fail(f"soak: {'; '.join(bad)}")
    report = [ln for ln in stdout.splitlines() if ln.startswith("lockdep:")]
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"soak: {res['iterations']} iterations in {SOAK_SECONDS} s on {res['device']}, none failed; "
          f"{report[-1] if report else ''}; templates {res['templates']} [{card}]", flush=True)
    return res


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
    phase("build")
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

    phase("kernel")
    kernels = kernel_phase(torch, np, K, bind, jax_pkg)
    kernels["fused_arith"]["ptxas"] = ptxas
    ops = bind(NORMALIZE, np.dtype(np.uint8))
    phase("batch_kernel")
    kernels["int8_matmul"]["at_m"], kernels["fused_arith"]["at_batch"] = batch_kernel_phase(
        torch, np, K, ops, jax_pkg)
    audio_ops = bind(AUDIO_NORMALIZE, np.dtype(np.int16))
    phase("graph_kernel")
    in_graph = graph_kernel_phase(torch, np, K, ops, audio_ops, bind)
    slices = {}
    phase("slice")
    by_path = {"image_labeling": slice_phase(torch, np, K, ops, root, card, slices)}
    phase("detection")
    by_path["object_detection"] = detection_phase(torch, np, K, ops, root, card, slices)
    phase("obs")
    observed = obs_phase(torch, np, slices, root, card)
    phase("audio")
    by_path["audio"] = audio_phase(torch, np, K, audio_ops, root, card)
    phase("upload_wait")
    upload_wait = upload_wait_phase(torch, np)
    phase("model_file")
    by_path["model_file"] = model_file_phase(torch, np, K, ops, root, card)
    phase("torchscript")
    torchscript = torchscript_phase(torch, np, K, ops, root)
    phase("drift")
    drift = drift_phase(torch, np, K, ops, bind)
    phase("custom_so")
    custom_so = custom_so_phase(torch, np, root)
    phase("quant")
    by_path["quant"], by_path["quant_int8_head"], by_path["quant_ssd"] = quant_phase(
        torch, np, K, ops, root, card, by_path["image_labeling"][1]["device_busy_ms_per_frame"])
    t1 = time.perf_counter()
    phase("pose")
    by_path["pose"], pose_heatmaps, pose_int8 = pose_phase(torch, np, K, ops, root, card)
    t2 = time.perf_counter()
    phase("recurrence")
    by_path["lstm"], lstm_seq = recurrence_phase(torch, np, K, root, card)
    t3 = time.perf_counter()
    phase("batch")
    batched = batch_phase(torch, np, K, ops, root, card, slices)
    for key in ("config5_n4", "config5_n8", "config1d"):
        by_path[key] = (batched[key]["launches"], batched[key])
    t4 = time.perf_counter()
    phase("cascade")
    launches, config2c, config2c_more = cascade_phase(torch, np, K, ops, root, card)
    by_path["config2c"] = (launches, config2c)
    by_path["config2c_dynbatch"] = (config2c_more["launches"], config2c_more)
    by_path["crop_cascade"] = (config2c_more["element_cascade"]["launches"], {})
    t5 = time.perf_counter()
    phase("app")
    app, app_launches = app_phase(torch, np, K, ops, root, card)
    by_path["app"] = (app["launches"], app)
    for key, counts in app_launches.items():
        by_path[key] = (counts, {})
    t6 = time.perf_counter()
    phase("vit")
    by_path["vit"], by_path["vit_w8a8"] = vit_phase(torch, np, K, ops, root, card, slices)
    t7 = time.perf_counter()
    K.reset_launches()
    phase("decode")
    by_path["config4c"], decode_tree = decode_phase(torch, np, K, root, card)
    t8 = time.perf_counter()
    K.reset_launches()
    phase("serving")
    config4d = serving_phase(torch, np, card, decode_tree,
                             by_path["config4c"][1]["steps_per_s"])
    by_path["config4d"] = ({k.__name__: k.launches for k in K.KERNELS}, config4d)
    t9 = time.perf_counter()
    phase("recovery")
    by_path["recovery"] = recovery_phase(torch, np, K, root, card, slices)
    t10 = time.perf_counter()
    phase("device_lane")
    by_path["device_lane"] = device_lane_phase(torch, np, K, root, card, slices,
                                               by_path["vit"][1]["busy_share_of_bf16_peak"])
    t11 = time.perf_counter()
    phase("lanes")
    by_path["lanes"] = lanes_phase(torch, np, K, root, card, slices)
    t12 = time.perf_counter()
    phase("profile")
    by_path["profile"] = profile_phase(torch, np, K, root, card, slices,
                                       by_path["image_labeling"][1]["device_busy_ms_per_frame"])
    t13 = time.perf_counter()
    phase("train")
    by_path["train"] = train_phase(torch, np, K, ops, root, card, slices)
    t14 = time.perf_counter()
    slices["decode_tree"] = decode_tree
    phase("query")
    by_path["query"] = query_phase(torch, np, K, root, card, slices)
    t15 = time.perf_counter()
    phase("c16")
    by_path["c16"] = c16_phase(torch, np, K, ops, card)
    t16 = time.perf_counter()
    phase("stream")
    by_path["stream"] = stream_phase(torch, np, K, root, card, slices)
    t17 = time.perf_counter()
    phase("parallel")
    mesh_launches, mesh = parallel_phase(torch, np, K, ops, root, card, slices)
    for key, counts in mesh_launches.items():
        by_path[key] = (counts, {})
    t18 = time.perf_counter()
    phase("fleet")
    by_path["fleet"] = fleet_phase(torch, np, K, root, card)
    t19 = time.perf_counter()
    phase("partition")
    by_path.update(partition_phase(torch, np, K, root, card))
    t20 = time.perf_counter()
    phase("native_queue")
    by_path.update(native_queue_phase(torch, np, K, root, card, slices))
    t21 = time.perf_counter()
    phase("autotune")
    kernels["int8_matmul"]["autotune"] = autotune_phase(torch, np, K, root, card)
    t22 = time.perf_counter()
    phase("soak")
    soak = soak_phase(root, card)
    faulthandler.cancel_dump_traceback_later()
    print(f"phase wall s: up to the quant phase {t1 - t0:.3f}, pose {t2 - t1:.3f}, "
          f"recurrence {t3 - t2:.3f}, batch {t4 - t3:.3f}, cascade {t5 - t4:.3f}, "
          f"app {t6 - t5:.3f}, vit {t7 - t6:.3f}, config 4c {t8 - t7:.3f}, "
          f"config 4d {t9 - t8:.3f}, recovery {t10 - t9:.3f}, "
          f"device lane {t11 - t10:.3f}, lanes {t12 - t11:.3f}, profile {t13 - t12:.3f}, "
          f"train {t14 - t13:.3f}, query {t15 - t14:.3f}, C16 {t16 - t15:.3f}, "
          f"stream {t17 - t16:.3f}, mesh {t18 - t17:.3f}, "
          f"fleet {t19 - t18:.3f}, partition {t20 - t19:.3f}, native queue {t21 - t20:.3f}, "
          f"autotune {t22 - t21:.3f}, soak {time.perf_counter() - t22:.3f}; "
          f"the script {time.perf_counter() - t0:.3f} after the import", flush=True)
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
                      "config1d": batched["config1d"], "pool_fence": batched["fence"],
                      "config2c": config2c, "config2c_dynbatch": config2c_more, "app": app,
                      "vit_b16": by_path["vit"][1], "vit_b16_w8a8": by_path["vit_w8a8"][1],
                      "config4c": by_path["config4c"][1], "config4d": config4d,
                      "recovery": by_path["recovery"][1],
                      "device_lane": by_path["device_lane"][1],
                      "lanes": by_path["lanes"][1], "profile": by_path["profile"][1],
                      "train": by_path["train"][1], "query": by_path["query"][1],
                      "c16": by_path["c16"][1], "stream": by_path["stream"][1],
                      "mesh": mesh, "fleet": by_path["fleet"][1],
                      "partition": by_path["partition_client"][1],
                      "native_queue": by_path["native_queue"][1],
                      "autotune": kernels["int8_matmul"]["autotune"], "soak": soak}),
          flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

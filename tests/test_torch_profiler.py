"""The port's deep-profiling lane against the JAX package's.

Class for class with ``tests/test_profiler.py``, on the CPU: where the
reference hand-builds an XPlane proto, these cases hand-build a Kineto
trace (``*.pt.trace.json``), the artifact ``torch.profiler`` writes.  A
capture window on the CPU sees no device: its table is the host-op
fallback (``device_planes == 0``).  Where the two packages share an input
(the gallery's eviction over one sequence, the attribution of one op
table, the detector's verdicts over one series of device times, the
memory ledger of one cost registry) both are fed and compared.

No case sets an ``NNSTPU_*`` variable (the JAX package reads the same
names): a conf-driven case gives the port's ``conf`` a copy of the
environment.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nnstreamer_tpu.obs import profiler as jprofiler
from nnstreamer_tpu.obs import util as jutil
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch import conf as tconf
from nnstreamer_tpu_torch import faults as tfaults
from nnstreamer_tpu_torch.backends.torch_backend import (CapturedGraph, TorchBackend,
                                                         TorchModel)
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.graph.pipeline import PipelineError
from nnstreamer_tpu_torch.obs import export as texport
from nnstreamer_tpu_torch.obs import hooks, profiler
from nnstreamer_tpu_torch.obs import util as tutil
from nnstreamer_tpu_torch.obs.device import memory_info
from nnstreamer_tpu_torch.obs.export import MetricsServer, render_text
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.obs.profiler import (HbmCapacityWarning, ProfileBusyError,
                                               ProfileGallery, categorize_op,
                                               parse_capture_dir)
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec
from nnstreamer_tpu_torch.utils import profiling


def _set_conf(monkeypatch, **keys):
    """The port's conf over a copy of the environment with ``keys`` set."""
    env = dict(tconf.conf._environ)
    env.update({k: str(v) for k, v in keys.items()})
    monkeypatch.setattr(tconf.conf, "_environ", env)


@pytest.fixture(autouse=True)
def _isolated_gallery(tmp_path, monkeypatch):
    """Every test gets its own gallery dir and a clean capture memory."""
    _set_conf(monkeypatch, NNSTPU_OBS_PROFILE_DIR=tmp_path / "gallery")
    profiler.reset_gallery()
    with profiler._last_lock:
        profiler._recent.clear()
    yield
    profiler.reset_gallery()
    with profiler._last_lock:
        profiler._recent.clear()
    hooks.clear()
    tfaults.deactivate()
    assert profiler.active_capture() is None


def slow_pipeline(got, n=100, sleep_s=0.02, name="prof"):
    def slow(x):
        time.sleep(sleep_s)
        return x * 2

    p = tnns.Pipeline(name=name)
    src = p.add(DataSrc(data=[np.full(4, i, np.float32) for i in range(n)]))
    filt = p.add(TensorFilter(framework="custom", model=slow, name="double"))
    sink = p.add(TensorSink(callback=got.append))
    p.link_chain(src, filt, sink)
    return p


# -- Kineto trace parsing -------------------------------------------------------


def _kineto(events, path):
    """Write a Kineto-style Chrome trace: ``events`` = [(cat, name, dur_us,
    device)] as complete ("X") events, plus the metadata and flow events a
    real trace holds."""
    evs = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}},
           {"ph": "f", "name": "ac2g", "cat": "ac2g", "pid": 0, "tid": 1, "ts": 1, "id": 7}]
    for i, (cat, name, dur, device) in enumerate(events):
        ev = {"ph": "X", "cat": cat, "name": name, "pid": device if device is not None else 7,
              "tid": 1, "ts": 10.0 * i, "dur": dur, "args": {}}
        if device is not None:
            ev["args"] = {"device": device, "stream": 7, "correlation": i}
        evs.append(ev)
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": evs}))
    return path


# H100 kernel names as CUPTI reports them, cuBLAS/CUTLASS/cuDNN/ATen and the
# port's own three (csrc/fused_arith.cu:507, int8_matmul.cu:99,249,
# nms_keep.cu:142,236), with the category each must land in
H100_KERNELS = [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_"
     "execute_segment_k_off_kernel__5x_cublas", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_"
     "align8>(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8::Params)",
     "matmul"),
    ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_64x4_tn", "matmul"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4, false, "
     "false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, "
     "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, "
     "float> >(cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, "
     "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, "
     "float>, float, float)", "matmul"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
     "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x64x64_"
     "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "conv"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
     "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "conv"),
    ("void conv2d_grouped_direct_kernel<false, true, false, false, 0, 0, int, __nv_bfloat16, "
     "__nv_bfloat16, __nv_bfloat16, float, float, true>(cudnn::cnn::GroupedDirectFpropParams,"
     " __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float, float, "
     "__nv_bfloat16 const*, float const*, cudnnActivationStruct)", "conv"),
    ("void dgrad2d_grouped_direct_kernel<__nv_bfloat16, float, int, __nv_bfloat16, false, "
     "true, 0>(cudnn::cnn::GroupedDirectDgradParams)", "conv"),
    ("void cudnn::cnn::wgrad2d_grouped_direct_kernel<false, true, int, __nv_bfloat16, float, "
     "float>(cudnn::cnn::GroupedDirectWgradParams)", "conv"),
    ("void cudnn::ops::nchwToNhwcKernel<float, float, float, false, true, "
     "(cudnnKernelDataType_t)2>(cudnn::ops::nchw2nhwc_params_t<float>, float const*, float*)",
     "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3>)", "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
     "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()()"
     " const::{lambda()#7}::operator()() const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()()"
     " const::{lambda()#7}::operator()() const::{lambda(float)#1} const&)::{lambda(int)#1}>"
     "(int, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda("
     "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, at::native::direct_copy_kernel_cuda("
     "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1} const&)::{lambda(int)#1})", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<"
     "float, float, float, float>, unsigned int, float, 4> >(at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, 4>)",
     "elementwise"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float, float, "
     "at::native::(anonymous namespace)::LogSoftMaxForwardEpilogue>(float*, float const*, "
     "int)", "elementwise"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous"
     " namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::"
     "BinaryOpListAlphaFunctor<float, 2, 2, 0>, std::plus<float>, float>(...)", "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
     "namespace)::OpaqueType<4u>, unsigned int, 4, 64, 64>(...)", "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void fused_arith_kernel<unsigned char, float, 0>(unsigned char const*, float*, long "
     "long, long long, long long, int, int, Program)", "elementwise"),
    ("int8_gemv_splitk_kernel(signed char const*, signed char const*, float const*, float "
     "const*, float const*, float*, int, int, int)", "matmul"),
    ("int8_matmul_kernel(signed char const*, signed char const*, float const*, float const*, "
     "float const*, float*, int, int, int)", "matmul"),
    ("nms_bits_kernel(float const*, float const*, float const*, float const*, bool const*, "
     "unsigned long long*, int)", "other"),
    ("nms_walk_kernel(float const*, float const*, float const*, float const*, bool const*, "
     "unsigned long long*, bool*, int)", "other"),
    # read off an H100's trace of slice 1 (cuDNN 9, cuBLASLt)
    ("nvjet_tst_64x8_64x16_1x4_h_bz_TNT", "matmul"),
    ("conv2d_c1_k1_nhwc", "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_"
     "32x4_nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_"
     "align8::Params)", "conv"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
     "(cudnnKernelDataType_t)0>(int, int, int, int, int, int, int, int, __nv_bfloat16 const*,"
     " __nv_bfloat16*, float, float, cudnn::reduced_divisor)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda("
     "at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >(int, "
     "at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, "
     "std::array<char*, 2ul>)", "elementwise"),
    ("void (anonymous namespace)::int8_gemv_splitk_kernel<1>(signed char const*, signed char "
     "const*, float const*, float const*, float const*, float*, int, int, int)", "matmul"),
    ("void (anonymous namespace)::fused_arith_kernel<unsigned char, float, true>(unsigned "
     "char const*, float*, long long, long long, long long, int, int, Program)", "elementwise"),
    ("aten::addmm", "matmul"),
    ("aten::conv2d", "conv"),
    ("aten::mul", "elementwise"),
    ("aten::copy_", "copy"),
]


class TestKinetoParsing:
    def test_parse_hand_built_trace(self, tmp_path):
        _kineto([("kernel", "fused_arith_kernel<uchar>", 2.5, 0),
                 ("kernel", "fused_arith_kernel<uchar>", 1.5, 0),
                 ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 4.0, 0),
                 ("gpu_memset", "Memset (Device)", 0.5, 0)], tmp_path / "a.pt.trace.json")
        parsed = parse_capture_dir(str(tmp_path))
        assert parsed["parser"] == "kineto" and parsed["device_planes"] == 1
        rows = {r["name"]: r for r in parsed["ops"]}
        assert rows["fused_arith_kernel<uchar>"]["dur_us"] == pytest.approx(4.0)
        assert rows["fused_arith_kernel<uchar>"]["count"] == 2
        assert rows["Memcpy HtoD (Pageable -> Device)"]["category"] == "copy"
        assert parsed["device_us_total"] == pytest.approx(8.5)
        assert parsed["artifacts"] == ["a.pt.trace.json"]

    def test_parse_capture_dir_prefers_device_events(self, tmp_path):
        _kineto([("cpu_op", "aten::mm", 9.0, None), ("cuda_runtime", "cudaLaunchKernel", 3.0,
                                                      None),
                 ("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 2.0, 0),
                 ("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 2.0, 0),
                 ("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 2.0, 0)],
                tmp_path / "b.pt.trace.json")
        parsed = parse_capture_dir(str(tmp_path))
        assert parsed["device_planes"] == 1
        assert [r["name"] for r in parsed["ops"]] == ["sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"]
        assert parsed["ops"][0]["category"] == "matmul"
        assert parsed["op_categories"]["matmul"] == pytest.approx(6.0)
        assert "/device:cuda:0" in parsed["planes"]

    def test_host_fallback_without_device_events(self, tmp_path):
        _kineto([("cpu_op", "aten::mm", 9.0, None), ("cpu_op", "aten::mul", 1.0, None)],
                tmp_path / "c.pt.trace.json")
        parsed = parse_capture_dir(str(tmp_path))
        assert parsed["device_planes"] == 0 and parsed["planes"] == ["/host:CPU"]
        assert [r["name"] for r in parsed["ops"]] == ["aten::mm", "aten::mul"]
        assert parsed["device_us_total"] == 0.0

    def test_unreadable_trace_never_fails(self, tmp_path):
        (tmp_path / "d.pt.trace.json").write_bytes(b"\xff\xff not json")
        (tmp_path / "e.xplane.pb").write_bytes(b"\x00")  # not a Kineto trace: ignored
        parsed = parse_capture_dir(str(tmp_path))
        assert parsed["ops_total"] == 0 and parsed["artifacts"] == ["d.pt.trace.json"]

    def test_top_k_keeps_the_longest(self, tmp_path):
        _kineto([("kernel", f"k{i}", float(i), 0) for i in range(30)],
                tmp_path / "f.pt.trace.json")
        parsed = parse_capture_dir(str(tmp_path), top_k=5)
        assert parsed["ops_total"] == 30
        assert [r["name"] for r in parsed["ops"]] == ["k29", "k28", "k27", "k26", "k25"]

    @pytest.mark.parametrize("name,category", H100_KERNELS,
                             ids=[f"{c}-{i}" for i, (_, c) in enumerate(H100_KERNELS)])
    def test_categorize_h100_kernel(self, name, category):
        assert categorize_op(name) == category

    def test_categorize_falls_back_to_other(self):
        assert categorize_op("while") == "other"
        assert categorize_op("cudaGraphLaunch") == "other"


# -- gallery ------------------------------------------------------------------


def _add(gal, cid, payload_bytes, when):
    os.makedirs(gal.capture_dir(cid), exist_ok=True)
    with open(os.path.join(gal.capture_dir(cid), "x.pt.trace.json"), "wb") as f:
        f.write(b"\0" * payload_bytes)
    return gal.add(cid, {"capture_id": cid, "started_unix": when})


class TestGallery:
    def test_newest_k_retained(self, tmp_path):
        gal = ProfileGallery(str(tmp_path), keep=2, max_bytes=1 << 20)
        for i in range(4):
            _add(gal, f"cap{i}", 10, when=1000.0 + i)
        assert gal.entries() == ["cap2", "cap3"]
        assert gal.evicted == 2
        assert not os.path.exists(gal.summary_path("cap0"))
        assert not os.path.isdir(gal.capture_dir("cap0"))

    def test_byte_cap_evicts_oldest(self, tmp_path):
        gal = ProfileGallery(str(tmp_path), keep=10, max_bytes=3000)
        _add(gal, "old", 2000, when=1.0)
        _add(gal, "new", 2000, when=2.0)
        assert gal.entries() == ["new"]
        assert gal.evicted == 1
        assert gal.summary()["bytes"] <= 3000

    def test_rescan_across_restart(self, tmp_path):
        gal = ProfileGallery(str(tmp_path), keep=4, max_bytes=1 << 20)
        _add(gal, "a", 10, when=1.0)
        _add(gal, "b", 10, when=2.0)
        gal2 = ProfileGallery(str(tmp_path), keep=1, max_bytes=1 << 20)
        assert gal2.entries() == ["a", "b"]
        _add(gal2, "c", 10, when=3.0)
        assert gal2.entries() == ["c"]

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_eviction_equals_the_reference(self, tmp_path, seed):
        """One seeded sequence of adds (sizes, out-of-order times, re-adds)
        through both galleries: the same entries, evictions and bytes."""
        rng = np.random.default_rng(seed)
        keep, cap = int(rng.integers(1, 5)), int(rng.integers(2000, 20000))
        gals = [ProfileGallery(str(tmp_path / "port"), keep, cap),
                jprofiler.ProfileGallery(str(tmp_path / "jax"), keep, cap)]
        for _ in range(12):
            cid = f"c{int(rng.integers(0, 8))}"
            size, when = int(rng.integers(10, 4000)), float(rng.integers(0, 100))
            kept = [_add(g, cid, size, when) for g in gals]
            assert [k is None for k in kept][0] == [k is None for k in kept][1]
            assert gals[0].entries() == gals[1].entries()
        assert gals[0].evicted == gals[1].evicted
        assert gals[0].summary()["bytes"] == gals[1].summary()["bytes"]


# -- capture windows ----------------------------------------------------------


class TestCaptureWindow:
    def test_capture_on_cpu_is_the_host_fallback(self):
        reg = MetricsRegistry()
        got = []
        # 20 s of frames: the stream still plays however long the
        # profiler's first start takes on a loaded host; stop ends it
        p = slow_pipeline(got, n=1000)
        p.start()
        try:
            summary = profiler.capture_profile(seconds=0.3, registry=reg)
        finally:
            p.stop()
        assert summary["parser"] == "kineto"
        assert summary["device_planes"] == 0 and summary["planes"] == ["/host:CPU"]
        assert summary["ops_total"] > 0  # the pipeline's threads' CPU ops
        assert summary["summary_path"] and os.path.exists(summary["summary_path"])
        assert summary["capture_id"] in profiler.gallery().entries()
        trace = os.path.join(summary["artifact_dir"], summary["capture_id"] + ".pt.trace.json")
        assert os.path.exists(trace) and summary["artifacts"]
        banked = json.load(open(summary["summary_path"]))
        assert banked["capture_id"] == summary["capture_id"]
        assert 'nnstpu_profile_captures_total{trigger="manual",outcome="ok"}' in \
            render_text(reg)
        assert profiler.last_capture()["capture_id"] == summary["capture_id"]
        assert summary["seconds"] == pytest.approx(0.3, abs=0.25)

    def test_concurrent_capture_raises_typed_busy(self):
        with profiler.profiled_window(label="holder", parse=False):
            with pytest.raises(ProfileBusyError) as ei:
                profiler.capture_profile(seconds=0.05)
            assert ei.value.status == 409
            assert ei.value.active["trigger"] == "manual"
            assert profiler.active_capture() is not None
            with pytest.raises(ProfileBusyError):
                with profiler.capture_lock("chip_smoke trace"):
                    pass
        assert profiler.active_capture() is None

    def test_pipeline_stop_abandons_window_cleanly(self):
        reg = MetricsRegistry()
        got = []
        p = slow_pipeline(got, name="abandon")
        p.start()
        stopper = threading.Timer(0.2, p.stop)
        stopper.start()
        try:
            t0 = time.monotonic()
            summary = profiler.capture_profile(seconds=30.0, pipeline=p, registry=reg)
            assert time.monotonic() - t0 < 15.0, "abandon must end the window"
            assert summary["aborted"] and "PLAYING" in summary["aborted"]
        finally:
            stopper.join()
            p.stop()
        assert 'trigger="manual",outcome="aborted"' in render_text(reg)
        # the lock is free again: the next capture must not see busy
        profiler.capture_profile(seconds=0.05, registry=reg)

    def test_frames_window_counts_device_exec(self):
        reg = MetricsRegistry()

        def feed():
            # emitted mid-window from another thread, as the device reaper does
            time.sleep(0.1)
            for _ in range(3):
                hooks.emit("device_exec", "p", "n", "cuda:0", 0, 1_000_000,
                           {"cost_key": "m:000000000001"})

        t = threading.Thread(target=feed)
        t.start()
        try:
            summary = profiler.capture_profile(frames=3, registry=reg)
        finally:
            t.join()
        assert summary["frames_observed"] >= 3
        assert summary["executables"]["m:000000000001"]["dispatches"] == 3
        assert summary["executables"]["m:000000000001"]["dur_us"] == pytest.approx(3000.0)

    def test_device_trace_writes_a_kineto_trace_under_the_lock(self, tmp_path):
        with profiling.device_trace(str(tmp_path / "dt")):
            assert profiler.active_capture()["trigger"] == "manual"
            torch.ones(8, 8) @ torch.ones(8, 8)
        files = profiler.find_trace_files(str(tmp_path / "dt"))
        assert len(files) == 1
        names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
        assert "aten::mm" in names
        assert profiler.last_capture() is None  # parse=False banks nothing


# -- fingerprint join + Chrome-trace drill-down --------------------------------


class TestAttribution:
    def test_single_fingerprint_attributes_all_rows(self):
        parsed = {"ops": [{"name": "sm90_xmma_gemm", "category": "matmul", "dur_us": 5.0,
                           "count": 1}]}
        profiler._attribute_executables(
            parsed, {"mobilenet:0000000000ab": {"dur_us": 9.0, "dispatches": 3}})
        assert parsed["ops"][0]["executable"] == "mobilenet:0000000000ab"

    def test_model_name_match_beats_dominant(self):
        parsed = {"ops": [
            {"name": "resnet_gemm.1", "category": "matmul", "dur_us": 5.0, "count": 1},
            {"name": "unrelated.add", "category": "elementwise", "dur_us": 1.0, "count": 1},
        ]}
        observed = {"resnet:00000000000a": {"dur_us": 1.0, "dispatches": 1},
                    "bert:00000000000b": {"dur_us": 99.0, "dispatches": 9}}
        profiler._attribute_executables(parsed, observed)
        assert parsed["ops"][0]["executable"] == "resnet:00000000000a"
        assert parsed["ops"][1]["executable"] == "bert:00000000000b"  # dominant

    def test_attribution_equals_the_reference(self):
        rng = np.random.default_rng(3)
        models = ["vit", "mobilenet", "ssd"]
        observed = {f"{m}:{i:012x}": {"dur_us": float(rng.uniform(1, 100)), "dispatches": 1}
                    for i, m in enumerate(models)}
        rows = [{"name": f"{models[int(rng.integers(0, 4)) % 3] if rng.random() < .5 else 'k'}"
                         f"_{i}", "category": "other", "dur_us": 1.0, "count": 1}
                for i in range(20)]
        ours, theirs = {"ops": [dict(r) for r in rows]}, {"ops": [dict(r) for r in rows]}
        profiler._attribute_executables(ours, observed)
        jprofiler._attribute_executables(theirs, observed)
        assert ours == theirs

    def test_annotate_chrome_trace_joins_device_exec_spans(self):
        summary = {
            "capture_id": "cap-join", "trigger": "manual", "parser": "kineto",
            "ops": [{"name": "gemm", "category": "matmul", "dur_us": 5.0, "count": 1,
                     "executable": "m:00000000000a"}],
            "op_categories": {"matmul": 5.0},
            "executables": {"m:00000000000a": {"dur_us": 5.0, "dispatches": 1}},
        }
        profiler._remember(summary)

        def doc():
            return {"traceEvents": [
                {"ph": "X", "name": "device_exec", "args": {"cost_key": "m:00000000000a"}},
                {"ph": "X", "name": "device_exec", "args": {"cost_key": "other:00000000000b"}},
                {"ph": "X", "name": "dispatch", "args": {}},
            ]}

        out = profiler.annotate_chrome_trace(doc())
        drill = out["otherData"]["profile_drilldown"]
        assert drill["capture_id"] == "cap-join"
        assert out["traceEvents"][0]["args"]["profile_capture"] == "cap-join"
        assert "profile_capture" not in out["traceEvents"][1]["args"]
        assert "profile_capture" not in out["traceEvents"][2]["args"]
        assert out == jprofiler.annotate_chrome_trace(doc(), summary)
        assert profiler.annotate_chrome_trace({"traceEvents": []}, {}) == {"traceEvents": []}

    def test_op_gauges_keyed_by_executable_and_category(self):
        reg = MetricsRegistry()
        profiler._export_op_gauges({"ops": [
            {"name": "gemm.1", "category": "matmul", "dur_us": 5.0, "count": 1,
             "executable": "m:00000000000a"},
            {"name": "gemm.2", "category": "matmul", "dur_us": 7.0, "count": 1,
             "executable": "m:00000000000a"},
        ]}, reg)
        line = next(l for l in render_text(reg).splitlines()
                    if l.startswith("nnstpu_op_time_us{"))
        assert 'executable="m:00000000000a"' in line and 'op_category="matmul"' in line
        assert float(line.rsplit(" ", 1)[1]) == pytest.approx(12.0)


# -- the whole-run trace (`[common] xplane_trace_dir`) --------------------------


class TestWholeRunFold:
    def test_trace_in_trace_dir_and_summary_banked(self, tmp_path, monkeypatch):
        trace_dir = tmp_path / "xplane"
        _set_conf(monkeypatch, NNSTPU_COMMON_XPLANE_TRACE_DIR=trace_dir)
        got = []
        slow_pipeline(got, n=6, sleep_s=0.03, name="wrun").run(timeout=60)
        assert len(got) == 6
        files = profiler.find_trace_files(str(trace_dir))
        assert len(files) == 1, "the trace must stay under the user's trace_dir"
        last = profiler.last_capture()
        assert last["trigger"] == "whole_run" and last["pipeline"] == "wrun"
        assert last["ops_total"] > 0
        # the summary is banked in the gallery; the trace is NOT gallery-owned
        assert os.path.exists(profiler.gallery().summary_path(last["capture_id"]))
        assert not os.path.isdir(profiler.gallery().capture_dir(last["capture_id"]))

    def test_profile_is_busy_while_whole_run_active(self, tmp_path):
        p = tnns.Pipeline(name="busyrun")
        assert profiler.start_whole_run(p, str(tmp_path / "t"))
        try:
            with pytest.raises(ProfileBusyError) as ei:
                profiler.capture_profile(seconds=0.05)
            assert ei.value.active["whole_run"] is True
        finally:
            summary = profiler.stop_whole_run(p)
        assert summary is not None and summary["trigger"] == "whole_run"
        profiler.capture_profile(seconds=0.05)  # lock released

    def test_start_failure_surfaces_health_not_exception(self):
        health = []
        hooks.connect("health", lambda *a: health.append(a))
        p = tnns.Pipeline(name="sick")
        with profiler.profiled_window(label="holder", parse=False):
            assert profiler.start_whole_run(p, "/nonexistent/d") is False
        assert profiler.stop_whole_run(p) is None  # never started
        assert health, "failure must surface on the health hook"
        _pipeline, healthy, reason = health[0]
        assert healthy is True and "xplane" in reason
        try:
            assert any(k.startswith("xplane:") for k in texport.health_document()["degraded"])
        finally:
            texport.unregister_degraded("xplane:sick")


# -- HTTP: /profile -------------------------------------------------------------


class TestProfileEndpoint:
    @pytest.fixture
    def server(self):
        srv = MetricsServer(port=0)
        srv.start()
        yield f"127.0.0.1:{srv.port}"
        srv.stop()

    def test_get_profile_200(self, server):
        with urllib.request.urlopen(f"http://{server}/profile?seconds=0.1", timeout=60) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert body["trigger"] == "http"
        assert body["requested_seconds"] == pytest.approx(0.1)
        assert "ops_total" in body and body["parser"] == "kineto"

    def test_get_profile_409_while_a_capture_runs(self, server):
        with profiler.profiled_window(label="holder", parse=False):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://{server}/profile?seconds=0.1", timeout=60)
            assert ei.value.code == 409
            doc = json.loads(ei.value.read())
            assert doc["error"] == "busy" and doc["active"]["trigger"] == "manual"

    @pytest.mark.parametrize("query", ["seconds=banana", "frames=1.5", "seconds=1&frames=x"])
    def test_get_profile_400_on_bad_params(self, server, query):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{server}/profile?{query}", timeout=60)
        assert ei.value.code == 400
        assert json.loads(ei.value.read())["error"] == "bad_request"


# -- the memory ledger ------------------------------------------------------------


def _register_fake(mod, fp="model:00000000000a", output=1024, temp=2048, code=512):
    mod.register_cost(fp, flops=1e6, bytes=1e4,
                      hbm={"argument_bytes": 4096, "output_bytes": output, "temp_bytes": temp,
                           "alias_bytes": 0, "generated_code_bytes": code})
    return fp


class TestHbmForensics:
    @pytest.fixture(autouse=True)
    def _clean_costs(self):
        for mod in (tutil, jutil):
            mod.clear_costs()
        yield
        for mod in (tutil, jutil):
            mod.clear_costs()

    def test_memory_info_of_a_capture(self):
        entry = CapturedGraph(None, None, (torch.zeros(2, 8),), (torch.zeros(2, 3),
                                                                 torch.zeros(2, dtype=torch.int64)),
                              3, 0.0, 0.0, pool_bytes=1 << 21)
        mi = memory_info(entry, parameter_bytes=4000)
        assert mi == {"argument_bytes": 4064, "parameter_bytes": 4000, "input_bytes": 64,
                      "output_bytes": 40, "temp_bytes": (1 << 21) - 40, "alias_bytes": 0,
                      "generated_code_bytes": 0}
        assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                "generated_code_bytes"} <= set(mi)
        entry.pool_bytes = None  # not measured: no temp kind
        assert "temp_bytes" not in memory_info(entry)

    def test_backend_records_memory_per_capture(self):
        w = torch.ones(8, 3)
        spec = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(2, 8)))

        def fake_capture(fn, in_spec, device):
            static_in = tuple(torch.zeros(t.shape) for t in in_spec.tensors)
            return CapturedGraph(None, fn, static_in, tuple(fn(*static_in)) if isinstance(
                fn(*static_in), tuple) else (fn(*static_in),), 3, 0.0, 0.0, pool_bytes=4096)

        be = TorchBackend()
        be.capture = staticmethod(fake_capture)
        be.open(TorchModel(apply=lambda p, x: x @ p, params=w, input_spec=spec, name="lin",
                           device="cpu"))
        be.reconfigure(spec)
        ledger = profiler.hbm_ledger()
        fp = be.cost_key()
        row = ledger["executables"][fp]
        assert row["parameter_bytes"] == 96 and row["input_bytes"] == 64
        assert row["output_bytes"] == 24 and row["temp_bytes"] == 4096 - 24
        assert row["resident_bytes"] == 4096
        assert ledger["largest_resident"] == fp

    def test_released_captures_leave_the_ledger(self):
        """An evicted capture's memory leaves the ledger, and a closed
        backend's; a live capture that registered the same fingerprint
        keeps its row when an older backend closes."""
        w = torch.ones(8, 3)

        def spec(b):
            return TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(b, 8)))

        def fake_capture(fn, in_spec, device):
            static_in = tuple(torch.zeros(t.shape) for t in in_spec.tensors)
            return CapturedGraph(None, fn, static_in, (fn(*static_in),), 3, 0.0, 0.0,
                                 pool_bytes=4096)

        def backend():
            be = TorchBackend()
            be.capture = staticmethod(fake_capture)
            be.open(TorchModel(apply=lambda p, x: x @ p, params=w, input_spec=spec(None),
                               name="lin", device="cpu"), "compile_cache=1")
            return be

        a = backend()
        a.reconfigure(spec(2))
        first = a.cost_key()
        a.reconfigure(spec(4))  # evicts the batch-2 capture
        second = a.cost_key()
        assert set(profiler.hbm_ledger()["executables"]) == {second}
        b = backend()
        b.reconfigure(spec(4))
        assert b.cost_key() == second  # one model and geometry: one fingerprint
        a.close()
        assert set(profiler.hbm_ledger()["executables"]) == {second}
        b.close()
        assert profiler.hbm_ledger() == {}
        assert tutil.cost_of(first) is not None  # the cost stays for the spans

    def test_train_step_memory_in_the_ledger_until_dropped(self):
        import gc

        from nnstreamer_tpu_torch import training

        entry = training._Captured(None, torch.zeros(4, 8), torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(()))
        state = [torch.zeros(8, 3), torch.zeros(8, 3)]
        training._register_memory(entry, state, torch.device("cpu"))
        (fp, row), = profiler.hbm_ledger()["executables"].items()
        assert fp.startswith("train_step:")
        assert row["parameter_bytes"] == 192 and row["input_bytes"] == 144
        assert row["output_bytes"] == 4 and "temp_bytes" not in row  # no pool on the CPU
        del entry
        gc.collect()
        assert profiler.hbm_ledger() == {}

    def test_ledger_names_largest_resident(self):
        for mod in (tutil, jutil):
            _register_fake(mod, "small:00000000000a", output=10, temp=10, code=10)
            _register_fake(mod, "big:00000000000b", output=9000, temp=9000, code=100)
        ledger = profiler.hbm_ledger()
        assert ledger["largest_resident"] == "big:00000000000b"
        # resident excludes argument bytes (parameters and static inputs)
        assert ledger["executables"]["small:00000000000a"]["resident_bytes"] == 30
        assert ledger["resident_estimate_bytes"] == 30 + 18100
        assert ledger == jprofiler.hbm_ledger()

    def test_capacity_check_warns_typed_never_raises(self):
        _register_fake(tutil)
        p = tnns.Pipeline(name="cap")
        with pytest.warns(HbmCapacityWarning):
            report = profiler.check_hbm_capacity(pipeline=p, capacity_bytes=1)
        assert report["over_capacity"] is True
        assert report["largest_resident"] == "model:00000000000a"
        assert p.hbm_report is report
        try:
            assert any(k.startswith("hbm:") for k in texport.health_document()["degraded"])
        finally:
            texport.unregister_degraded("hbm:cap")

    def test_capacity_check_clean_under_capacity(self):
        _register_fake(tutil)
        report = profiler.check_hbm_capacity(capacity_bytes=1 << 40)
        assert report["over_capacity"] is False
        # no card in use here: no capacity to compare with
        assert profiler.device_capacity_bytes() is None
        assert profiler.check_hbm_capacity()["capacity_bytes"] is None

    def test_hbm_gauges_exported_per_kind(self):
        _register_fake(tutil)
        reg = MetricsRegistry()
        handle = profiler.register_hbm_gauges(reg)
        assert profiler.register_hbm_gauges(reg) is handle  # idempotent
        by_kind = {}
        for line in render_text(reg).splitlines():
            if (line.startswith("nnstpu_executable_hbm_bytes{")
                    and 'executable="model:00000000000a"' in line):
                kind = line.split('kind="', 1)[1].split('"', 1)[0]
                by_kind[kind] = float(line.rsplit(" ", 1)[1])
        assert by_kind["output_bytes"] == 1024
        assert by_kind["resident_bytes"] == 1024 + 2048 + 512

    def test_flight_dump_embeds_ledger_on_injected_fault(self, tmp_path, monkeypatch):
        _register_fake(tutil, "crash:00000000000c", output=7777)
        _set_conf(monkeypatch, NNSTPU_OBS_FLIGHT_DUMP_DIR=tmp_path)
        tfaults.install("invoke_raise@boom:after=1", seed=7)
        p = tnns.Pipeline(name="oomish")
        src = p.add(DataSrc(data=[np.ones(4, np.float32)] * 3, name="s"))
        filt = p.add(TensorFilter(framework="custom", model=lambda x: x, name="boom"))
        p.link_chain(src, filt, p.add(TensorSink(name="out")))
        p.attach_tracer("spans")
        with pytest.raises(PipelineError):
            p.run(timeout=30)
        doc = json.loads((tmp_path / "oomish.error.trace.json").read_text())
        ledger = doc["otherData"]["hbm_ledger"]
        assert ledger["largest_resident"] == "crash:00000000000c"
        assert ledger["executables"]["crash:00000000000c"]["output_bytes"] == 7777

    def test_warmup_report_carries_capacity_check(self):
        got = []
        p = slow_pipeline(got, n=2, sleep_s=0.0, name="warm")
        p.start()
        try:
            p.warmup()
            assert "hbm" in p.warmup_report
            assert p.warmup_report["hbm"]["over_capacity"] is False
            assert p.hbm_report is p.warmup_report["hbm"]
        finally:
            p.stop()

    def test_conf_driven_warmup_carries_it_too(self, monkeypatch):
        _register_fake(tutil)
        _set_conf(monkeypatch, NNSTPU_COMPILE_WARMUP="true")
        got = []
        p = slow_pipeline(got, n=2, sleep_s=0.0, name="warm_conf")
        p.run(timeout=30)
        assert p.warmup_report["hbm"]["executables"] == 1
        assert p.warmup_report["hbm"]["largest_resident"] == "model:00000000000a"


# -- degrade detection (the watchdog's auto-capture trigger) -------------------


class TestDegradeDetector:
    @staticmethod
    def _feed(det, dur_us, n=1, key="m:00000000000a"):
        for _ in range(n):
            det.on_device_exec("p", "node", "cuda:0", 0, int(dur_us * 1e3), {"cost_key": key})

    def test_arms_only_beyond_noise_band(self):
        det = profiler.DegradeDetector(sigmas=3.0, min_rel=0.10, min_abs_us=50.0,
                                       min_samples=8)
        self._feed(det, 1000.0, n=8)
        assert det.degraded() is None  # the baseline, nothing armed
        self._feed(det, 1010.0)  # inside the band (min_rel floor = 100 µs)
        assert det.degraded() is None
        self._feed(det, 2000.0)  # far out
        verdict = det.degraded()
        assert verdict is not None and "m:00000000000a" in verdict
        assert det.degraded() is None, "the verdict clears on read"
        assert det.verdicts == 1

    @pytest.mark.parametrize("seed", range(6))
    def test_verdicts_equal_the_reference(self, seed):
        """One seeded series of device times (several keys, a jittered
        baseline, spikes): the same verdicts, in the same words."""
        rng = np.random.default_rng(seed)
        kw = dict(sigmas=float(rng.uniform(2, 4)), min_rel=float(rng.uniform(0.05, 0.2)),
                  min_abs_us=float(rng.uniform(5, 80)), min_samples=int(rng.integers(4, 40)))
        ours, theirs = profiler.DegradeDetector(**kw), jprofiler.DegradeDetector(**kw)
        for _ in range(400):
            key = f"m{int(rng.integers(0, 3))}:{0:012x}" if rng.random() < 0.9 else None
            dur_ns = int(rng.normal(2000, 150) * 1e3) if rng.random() < 0.97 else \
                int(rng.uniform(3000, 9000) * 1e3)
            info = {"cost_key": key} if key else {}
            for det in (ours, theirs):
                det.on_device_exec("p", "f", "cuda:0", 0, dur_ns, info)
            if rng.random() < 0.2:
                assert ours.degraded() == theirs.degraded()
        assert ours.verdicts == theirs.verdicts
        assert ours.degraded(clear=False) == theirs.degraded(clear=False)

    def test_watchdog_auto_capture_on_injected_regression(self, monkeypatch):
        _set_conf(monkeypatch, NNSTPU_OBS_PROFILE_AUTO="true",
                  NNSTPU_OBS_PROFILE_AUTO_SECONDS="0.1", NNSTPU_OBS_PROFILE_AUTO_COOLDOWN_S="0",
                  NNSTPU_OBS_PROFILE_MIN_SAMPLES="8", NNSTPU_OBS_WATCHDOG_INTERVAL="0.05")
        from nnstreamer_tpu_torch.obs.watchdog import PipelineWatchdog

        got = []
        p = slow_pipeline(got, n=400, sleep_s=0.01, name="wdprof")
        reg = MetricsRegistry()
        wd = PipelineWatchdog(registry=reg)
        p.attach_tracer(wd)
        p.start()
        try:
            assert wd._profile_detector is not None and wd._interval == 0.05
            for _ in range(12):
                hooks.emit("device_exec", "wdprof", "n", "cuda:0", 0, 1_000_000,
                           {"cost_key": "wd:00000000000d"})
            hooks.emit("device_exec", "wdprof", "n", "cuda:0", 0, 50_000_000,
                       {"cost_key": "wd:00000000000d"})
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and wd.summary()["profile_auto"]["captures"] < 1:
                time.sleep(0.05)
            assert wd.summary()["profile_auto"]["captures"] >= 1, "the watchdog must capture"
        finally:
            p.stop()
        last = profiler.last_capture()
        assert last is not None and last["trigger"] == "watchdog"
        # the capture ran on a thread of its own, over the watched pipeline
        assert last["pipeline"] == "wdprof"

    def test_first_verdict_captures_whatever_the_cooldown(self, monkeypatch):
        """The cooldown spaces captures; it never holds back the first one
        (a cooldown longer than the host's uptime included)."""
        _set_conf(monkeypatch, NNSTPU_OBS_PROFILE_AUTO="true",
                  NNSTPU_OBS_PROFILE_AUTO_SECONDS="0.05",
                  NNSTPU_OBS_PROFILE_AUTO_COOLDOWN_S=str(1e12),
                  NNSTPU_OBS_PROFILE_MIN_SAMPLES="4")
        from nnstreamer_tpu_torch.obs.watchdog import PipelineWatchdog

        p = tnns.Pipeline(name="wdfirst")
        wd = PipelineWatchdog(interval_s=0.02)
        wd.start(p)
        p.state = "PLAYING"
        try:
            for dur in [1_000_000] * 6 + [90_000_000, 90_000_000]:
                hooks.emit("device_exec", "wdfirst", "n", "cuda:0", 0, dur, {})
            assert wd_wait(lambda: wd.summary()["profile_auto"]["captures"] == 1)
            for _ in range(3):
                hooks.emit("device_exec", "wdfirst", "n", "cuda:0", 0, 90_000_000, {})
            time.sleep(0.3)
            assert wd.summary()["profile_auto"]["captures"] == 1  # the cooldown holds
        finally:
            p.state = "STOPPED"
            wd.stop()

    def test_auto_capture_skips_when_busy(self, monkeypatch):
        _set_conf(monkeypatch, NNSTPU_OBS_PROFILE_AUTO="true",
                  NNSTPU_OBS_PROFILE_AUTO_COOLDOWN_S="0", NNSTPU_OBS_PROFILE_MIN_SAMPLES="4")
        from nnstreamer_tpu_torch.obs.watchdog import PipelineWatchdog

        p = tnns.Pipeline(name="wdbusy")
        wd = PipelineWatchdog(interval_s=0.02)
        wd.start(p)
        try:
            with profiler.profiled_window(label="holder", parse=False):
                p.state = "PLAYING"
                for _ in range(6):
                    hooks.emit("device_exec", "wdbusy", "n", "cuda:0", 0, 1_000_000, {})
                hooks.emit("device_exec", "wdbusy", "n", "cuda:0", 0, 90_000_000, {})
                assert wd_wait(lambda: wd._profile_detector.verdicts >= 1)
                time.sleep(0.3)  # the monitor's tick saw it; the capture found the lock held
            assert wd.summary()["profile_auto"]["captures"] == 0
        finally:
            p.state = "STOPPED"
            wd.stop()

    def test_stats_provider_reports_gallery_and_last(self):
        profiler.capture_profile(seconds=0.05, registry=MetricsRegistry())
        st = profiler.stats()
        assert st["gallery"]["entries"] >= 1
        assert st["last_capture"]["trigger"] == "manual"
        assert st["last_capture"]["parser"] == "kineto"


def wd_wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()

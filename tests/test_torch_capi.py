"""The port's C API: its glue against the JAX package's, and the library.

``nnstreamer_tpu_torch.api.capi_glue`` must give the same ``(bytes,
dtype_name, shape)`` triples as the reference's glue for the same values,
bfloat16 included (the reference's ml_dtypes bfloat16 and the port's
torch.bfloat16 carry the same 16-bit words), and its single-shot and
pipeline entries must give the reference's results.  Then the library
(``libnnstreamer_tpu_torch_capi.so``, built with ``g++``) is loaded with
ctypes and its ``ml_single_invoke`` held byte for byte to
:class:`SingleShot`, and the C smoke program beside it is built and run.
Everything here runs on the CPU (``NNSTPU_FILTER_TORCH_DEVICE=cpu``); the
tests that build the library skip where there is no ``g++``, as
``tests/test_capi.py`` does.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.api import capi_glue as jg
from nnstreamer_tpu_torch.api import capi_glue as g

ML_ERROR_NONE = 0
ML_TENSOR_TYPE_FLOAT32 = 7
PASSTHROUGH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "nnstreamer_tpu_torch", "examples", "custom_filters", "passthrough.py")
CAPS = "'other/tensor, dimension=(string)4:1:1:1, type=(string)float32'"

needs_gpp = pytest.mark.skipif(shutil.which("g++") is None, reason="needs a C++ toolchain")


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cpu")


VALUES = {
    "float32": np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32),
    "uint8": np.arange(12, dtype=np.uint8).reshape(3, 4),
    "int16": np.array([-3, 0, 7], np.int16),
    "float16": np.array([1.5, -0.25, 65504], np.float16),
    "int64": np.array([[1 << 40]], np.int64),
    "scalar": np.array(2.5, np.float32),
}


class TestWire:
    @pytest.mark.parametrize("name", sorted(VALUES))
    def test_triples_equal_the_reference(self, name):
        a = VALUES[name]
        assert g._to_wire([torch.from_numpy(a)]) == jg._to_wire([a])
        assert g._to_wire([a]) == jg._to_wire([a])

    def test_bfloat16_triple(self):
        x = np.array([[1.5, -2.0, 3.140625], [1e-39, -0.0, 65280.0]], np.float32)
        want = jg._to_wire([jnp.asarray(x, jnp.bfloat16)])
        got = g._to_wire([torch.from_numpy(x).to(torch.bfloat16)])
        assert got == want and got[0][1] == "bfloat16"
        back = g._to_tensors(got)[0]
        assert back.dtype == torch.bfloat16
        np.testing.assert_array_equal(back.float().numpy(),
                                      x.astype(ml_dtypes.bfloat16).astype(np.float32))

    @pytest.mark.parametrize("name", sorted(VALUES))
    def test_round_trip(self, name):
        a = VALUES[name]
        (t,) = g._to_tensors(jg._to_wire([a]))
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), a)
        assert g._to_tensors([(b"", "float32", (0, 3))])[0].shape == (0, 3)

    def test_inputs_own_their_memory(self):
        buf = np.arange(4, dtype=np.float32).tobytes()
        (t,) = g._to_tensors([(buf, "float32", (4,))])
        t += 1  # writable, and not the caller's bytes
        assert np.frombuffer(buf, np.float32)[0] == 0.0

    def test_spec_wire_round_trip(self):
        from nnstreamer_tpu.spec import TensorSpec as JSpec, TensorsSpec as JSpecs
        from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

        spec = TensorsSpec.of(TensorSpec(np.float32, (2, 3)), TensorSpec(np.uint8, (4,)))
        jspec = JSpecs.of(JSpec(np.float32, (2, 3)), JSpec(np.uint8, (4,)))
        assert g._spec_to_wire(spec) == jg._spec_to_wire(jspec) == [("float32", (2, 3)),
                                                                     ("uint8", (4,))]
        back = g._spec_from_wire(g._spec_to_wire(spec))
        assert back.tensors[1].shape == (4,) and back.tensors[0].dtype == np.dtype(np.float32)
        assert g._spec_to_wire(None) is None


class TestSingleGlue:
    def test_against_the_reference_glue(self, tmp_path):
        for mod in ("nnstreamer_tpu", "nnstreamer_tpu_torch"):
            (tmp_path / f"double_{mod}.py").write_text(
                f"from {mod}.backends.custom import CustomFilterBase\n"
                "class CustomFilter(CustomFilterBase):\n"
                "    def set_input_spec(self, spec):\n"
                "        return spec\n"
                "    def invoke(self, x):\n"
                "        return x * 2\n")
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        wire = [(x.tobytes(), "float32", (2, 3))]
        out = []
        for glue, mod in ((jg, "nnstreamer_tpu"), (g, "nnstreamer_tpu_torch")):
            s = glue.single_open("custom-python", str(tmp_path / f"double_{mod}.py"))
            glue.single_set_input_info(s, [("float32", (2, 3))])
            out.append((glue.single_invoke(s, wire), glue.single_input_info(s),
                        glue.single_output_info(s)))
            glue.single_set_timeout(s, 5000)
            glue.single_close(s)
        assert out[1] == out[0]
        assert out[1][1] == [("float32", (2, 3))]

    def test_torch_model_on_the_single_shot_device(self, tmp_path):
        from nnstreamer_tpu_torch.api import SingleShot

        model = tmp_path / "m.py"
        model.write_text(
            "import numpy as np\n"
            "from nnstreamer_tpu_torch.backends.torch_backend import TorchModel\n"
            "from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec\n"
            "def get_model():\n"
            "    return TorchModel(apply=lambda p, x: (x * 3 - 1).to(__import__('torch')"
            ".bfloat16), device='cpu',\n"
            "        input_spec=TensorsSpec.of(TensorSpec(np.float32, (4,))))\n")
        s = g.single_open("torch", str(model))
        x = np.array([0.5, 1.0, -2.0, 3.3], np.float32)
        got = g.single_invoke(s, [(x.tobytes(), "float32", (4,))])
        g.single_close(s)
        with SingleShot(framework="torch", model=str(model), device="cpu") as ref:
            want = g._to_wire(ref.invoke(x))
        assert got == want and got[0][1] == "bfloat16"


class TestPipelineGlue:
    def test_construct_control_sink_src(self):
        out = []
        for glue, dev in ((jg, ""), (g, " device=cpu")):
            h = glue.pipeline_construct(
                f"appsrc name=in caps={CAPS} ! tensor_transform mode=arithmetic "
                f"option=mul:3 acceleration=false{dev} ! tensor_sink name=out")
            got, evt = [], threading.Event()

            def cb(tensors, got=got, evt=evt):
                got.append(tensors)
                evt.set()

            glue.pipeline_sink_register(h, "out", cb)
            glue.pipeline_start(h)
            assert glue.pipeline_get_state(h) == "PLAYING"
            x = np.array([1.0, -2.5, 3.0, 0.125], np.float32)
            glue.pipeline_src_input(h, "in", [(x.tobytes(), "float32", (4,))])
            assert evt.wait(30)
            glue.pipeline_src_eos(h, "in")
            assert glue.pipeline_wait(h, 30_000)
            glue.pipeline_sink_unregister(h, "out", cb)
            glue.pipeline_stop(h)
            glue.pipeline_destroy(h)
            out.append(got)
        assert out[1] == out[0] and len(out[1]) == 1

    def test_valve_and_switch_control(self):
        seen_all = []
        for glue in (jg, g):
            h = glue.pipeline_construct(
                "appsrc name=in caps='other/tensor, dimension=(string)2:1:1:1, "
                "type=(string)float32' ! valve name=v ! output-selector name=sel "
                "sel.src_0 ! tensor_sink name=a sel.src_1 ! tensor_sink name=b")
            seen = {"a": 0, "b": 0}
            glue.pipeline_sink_register(h, "a", lambda t, s=seen: s.__setitem__("a", s["a"] + 1))
            glue.pipeline_sink_register(h, "b", lambda t, s=seen: s.__setitem__("b", s["b"] + 1))
            glue.pipeline_start(h)
            wire = [(np.zeros((2,), np.float32).tobytes(), "float32", (2,))]
            glue.pipeline_valve_set_open(h, "v", False)
            glue.pipeline_src_input(h, "in", wire)
            time.sleep(0.2)
            glue.pipeline_valve_set_open(h, "v", True)
            glue.pipeline_src_input(h, "in", wire)
            time.sleep(0.2)
            assert set(glue.pipeline_switch_pads(h, "sel")) >= {"src_0", "src_1"}
            glue.pipeline_switch_select(h, "sel", "src_1")
            glue.pipeline_src_input(h, "in", wire)
            glue.pipeline_src_eos(h, "in")
            assert glue.pipeline_wait(h, 30_000)
            glue.pipeline_stop(h)
            glue.pipeline_destroy(h)
            seen_all.append(seen)
        assert seen_all[1] == seen_all[0] == {"a": 1, "b": 1}


@pytest.fixture(scope="module")
def capi_lib(tmp_path_factory):
    from nnstreamer_tpu_torch.native import capi

    lib = ctypes.CDLL(capi.build_capi(tmp_path_factory.mktemp("capi")))
    lib.ml_tensors_info_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.ml_tensors_data_get_tensor_data.argtypes = [
        ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t)]
    return lib


@needs_gpp
class TestLibrary:
    def test_single_invoke_equals_single_shot(self, capi_lib, tmp_path):
        """ml_single_* on a torch model from a file, called through ctypes
        from this interpreter: the output bytes equal SingleShot's."""
        from nnstreamer_tpu_torch.api import SingleShot

        model = tmp_path / "affine.py"
        model.write_text(
            "import numpy as np, torch\n"
            "from nnstreamer_tpu_torch.backends.torch_backend import TorchModel\n"
            "from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec\n"
            "W = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3))"
            ".astype(np.float32))\n"
            "def get_model():\n"
            "    return TorchModel(apply=lambda p, x: x @ W, device='cpu',\n"
            "        input_spec=TensorsSpec.of(TensorSpec(np.float32, (4,))))\n")
        lib = capi_lib
        info = ctypes.c_void_p()
        assert lib.ml_tensors_info_create(ctypes.byref(info)) == ML_ERROR_NONE
        lib.ml_tensors_info_set_count(info, 1)
        lib.ml_tensors_info_set_tensor_type(info, 0, ML_TENSOR_TYPE_FLOAT32)
        lib.ml_tensors_info_set_tensor_dimension(info, 0, 1, (ctypes.c_uint32 * 8)(4))
        single = ctypes.c_void_p()
        assert lib.ml_single_open(ctypes.byref(single), str(model).encode(), b"torch", b"",
                                  info) == ML_ERROR_NONE
        data = ctypes.c_void_p()
        assert lib.ml_tensors_data_create(info, ctypes.byref(data)) == ML_ERROR_NONE
        x = np.array([1.0, 2.5, -3.0, 4.0], np.float32)
        payload = (ctypes.c_float * 4)(*x)
        assert lib.ml_tensors_data_set_tensor_data(data, 0, payload,
                                                   ctypes.sizeof(payload)) == ML_ERROR_NONE
        out = ctypes.c_void_p()
        assert lib.ml_single_invoke(single, data, ctypes.byref(out)) == ML_ERROR_NONE
        raw, size = ctypes.c_void_p(), ctypes.c_size_t()
        assert lib.ml_tensors_data_get_tensor_data(out, 0, ctypes.byref(raw),
                                                   ctypes.byref(size)) == ML_ERROR_NONE
        got = ctypes.string_at(raw, size.value)
        lib.ml_tensors_data_destroy(data)
        lib.ml_tensors_data_destroy(out)
        lib.ml_tensors_info_destroy(info)
        assert lib.ml_single_close(single) == ML_ERROR_NONE
        with SingleShot(framework="torch", model=str(model), device="cpu") as s:
            want = s.invoke(x)[0].numpy().tobytes()
        assert got == want and len(got) == 12

    def test_smoke_program(self, tmp_path):
        """The C smoke program (CRUD, single-shot on the passthrough
        filter, a pipeline with appsrc, a transform, a valve and a sink
        callback) built against the library and run as its own process."""
        from conftest import cpu_subprocess_env
        from nnstreamer_tpu_torch.native import capi

        binary = capi.build_smoke(tmp_path / "capi_smoke", tmp_path / "build")
        env = cpu_subprocess_env()
        env["NNSTPU_FILTER_TORCH_DEVICE"] = "cpu"
        site = [p for p in sys.path if p.endswith("site-packages")]
        env["PYTHONPATH"] = os.pathsep.join([env["PYTHONPATH"]] + site)
        proc = subprocess.run([binary, PASSTHROUGH, "cpu"], capture_output=True, text=True,
                              timeout=300, env=env)
        assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr}"
        assert proc.stdout.split() == ["info/data", "CRUD", "ok", "single-shot", "ok",
                                       "pipeline", "ok"]

    def test_build_key_and_rebuild(self, tmp_path, monkeypatch):
        """The stamp keys on the sources and the interpreter's ABI: a
        matching stamp loads the library as it is, a foreign one rebuilds."""
        import sysconfig

        from nnstreamer_tpu_torch.native import capi

        key = capi.build_key()
        so = capi.build_capi(tmp_path)
        stamp = so + ".stamp"
        assert open(stamp).read() == key
        os.utime(so, (1, 1))
        assert capi.build_capi(tmp_path) == so and os.path.getmtime(so) == 1
        with open(stamp, "w") as f:
            f.write("foreign-key")
        capi.build_capi(tmp_path)
        assert os.path.getmtime(so) != 1 and open(stamp).read() == key
        monkeypatch.setattr(sysconfig, "get_platform", lambda: "foreign-arch-1.0")
        assert capi.build_key() != key


@needs_gpp
def test_build_holds_no_lock_c25(tmp_path):
    """ROADMAP C25: two threads asking for the C API library build it with
    no lock held around ``g++`` (the JAX package holds its lock there:
    lockdep's blocking_call_under_lock), and both get a library that loads."""
    from nnstreamer_tpu_torch.analysis import lockdep
    from nnstreamer_tpu_torch.native import capi

    fresh = lockdep.install()
    lockdep.reset()
    saved = capi._lock
    try:
        capi._lock = threading.Lock()  # a lock lockdep tracks
        paths = []
        ts = [threading.Thread(target=lambda: paths.append(capi.build_capi(tmp_path)))
              for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert len(paths) == 2 and paths[0] == paths[1]
        assert lockdep.findings("blocking_call_under_lock") == [], lockdep.format_report()
        ctypes.CDLL(paths[0])
        assert not list(tmp_path.glob("*.tmp.*"))
    finally:
        capi._lock = saved
        if fresh:
            lockdep.uninstall()
        else:
            lockdep.reset()

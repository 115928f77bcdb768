"""Models from files and user filters in the port, against the JAX package.

- ``utils/checkpoint.py``: a file either package's ``save_state`` wrote
  loads in the other to the same tree, bit for bit;
- ``framework=torch`` with ``model=`` a ``.npz`` checkpoint and
  ``custom=builder=...`` (a built-in builder, or ``file.py:fn``), a ``.py``
  model file and a TorchScript file, each against the JAX package's
  backend on the same file (the checkpoint the JAX package wrote) and the
  same inputs;
- ``custom``, ``custom-python`` (the port's example filters against the JAX
  package's) and ``custom-easy``.

The port runs on the CPU: models from files follow ``[filter]
torch_device``, set here with ``NNSTPU_FILTER_TORCH_DEVICE=cpu``.
"""

import importlib.machinery
import os
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.jax_backend import JaxBackend
from nnstreamer_tpu.backends import custom as jcustom
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.spec import TensorSpec as JTensorSpec, TensorsSpec as JTensorsSpec
from nnstreamer_tpu.utils import checkpoint as jckpt
from nnstreamer_tpu_torch.backends import custom as tcustom
from nnstreamer_tpu_torch.backends.base import get_backend
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend, TorchModel
from nnstreamer_tpu_torch.graph.node import NegotiationError
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec
from nnstreamer_tpu_torch.utils import checkpoint as tckpt

REPO = Path(__file__).resolve().parent.parent
KW = dict(num_classes=10, width_mult=0.35, image_size=64)
BUILDER_KW = "num_classes=10,width_mult=0.35,image_size=64"


@pytest.fixture(autouse=True)
def cpu_models(monkeypatch):
    monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cpu")


def _frames(seed, n=3, shape=(64, 64, 3)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(n)]


def _trees_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _trees_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


# -- utils/checkpoint.py ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """MobileNet-v2 (width 0.35, 64x64, 10 classes) params written by the
    JAX package's save_state."""
    path = str(tmp_path_factory.mktemp("ckpt") / "mobilenet_v2.npz")
    params = jm.build(**KW).params
    jckpt.save_state(params, path)
    return path, jax.tree_util.tree_map(np.asarray, params)


TREE = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "n": [np.int8(-3) * np.ones(5, np.int8),
        (np.float16(1.5) * np.ones(2, np.float16), None)], "meta": {"stride": 2, "res": True,
        "name": "block", "lr": 0.5, "u": np.array(7, np.uint32)}}


class TestCheckpoint:
    def test_reference_file_loads_bitwise(self, tmp_path):
        jckpt.save_state(TREE, str(tmp_path / "a.npz"))
        _trees_equal(tckpt.load_state(str(tmp_path / "a.npz")), TREE)

    def test_port_file_loads_in_the_reference(self, tmp_path):
        tree = dict(TREE, t=torch.arange(6, dtype=torch.int16))
        tckpt.save_state(tree, str(tmp_path / "b"))  # np.savez adds .npz
        want = dict(TREE, t=np.arange(6, dtype=np.int16))
        _trees_equal(jckpt.load_state(str(tmp_path / "b")), want)
        _trees_equal(tckpt.load_state(str(tmp_path / "b.npz")), want)

    def test_model_params_round_trip(self, jax_checkpoint):
        path, params = jax_checkpoint
        got = tckpt.load_state(path)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(params)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()

    def test_no_pickle(self, tmp_path):
        with pytest.raises(TypeError, match="cannot checkpoint"):
            tckpt.save_state({"f": object()}, str(tmp_path / "c.npz"))

    def test_orbax_directory_without_orbax_raises_the_same_error(self, tmp_path, monkeypatch):
        monkeypatch.setitem(sys.modules, "orbax", None)
        monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
        errors = []
        for load in (jckpt.load_state, tckpt.load_state):
            with pytest.raises(ImportError) as err:
                load(str(tmp_path))
            errors.append(str(err.value))
        assert errors[0] == errors[1] and "orbax" in errors[1]

    def test_orbax_directory_never_imports_orbax(self, tmp_path, monkeypatch):
        """Where orbax is installed the port still refuses the directory,
        without importing orbax (which imports JAX)."""
        orbax = types.ModuleType("orbax")
        orbax.__spec__ = importlib.machinery.ModuleSpec("orbax", None)
        monkeypatch.setitem(sys.modules, "orbax", orbax)
        monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)  # importing it raises
        with pytest.raises(ImportError, match="the port does not restore"):
            tckpt.load_state(str(tmp_path))


# -- framework=torch: models from files ---------------------------------------


def _jax_invoke(path, custom, x, spec):
    be = JaxBackend()
    be.open(path, custom)
    be.reconfigure(spec)
    return np.asarray(be.invoke((x,))[0])


class TestCheckpointModels:
    def test_reference_checkpoint_serves_with_a_builtin_builder(self, jax_checkpoint):
        """bf16 compute in both: logits within test_torch_mobilenet.py's
        0.15, equal top-1."""
        path, _ = jax_checkpoint
        custom = f"builder=mobilenet_v2:build,{BUILDER_KW}"
        be = TorchBackend()
        be.open(path, custom)
        assert be.device.type == "cpu" and be.model.name == "mobilenet_v2_0.35_64"
        spec = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(64, 64, 3)))
        be.reconfigure(spec)
        jspec = JTensorsSpec.of(JTensorSpec(dtype=np.float32, shape=(64, 64, 3)))
        for x in _frames(0):
            want = _jax_invoke(path, custom, x, jspec)
            got = be.invoke((torch.from_numpy(x),))[0].numpy()
            assert got.shape == want.shape == (10,)
            assert np.argmax(got) == np.argmax(want)
            np.testing.assert_allclose(got, want, atol=0.15)

    def test_quantized_builder_with_int8_head_from_a_launch_string(self, jax_checkpoint):
        """The launch string alone names the model: build_quantized with the
        int8 head, the normalize folded in; labels as the builder called
        directly on the same params."""
        path, params = jax_checkpoint
        frames = [np.random.default_rng(i).integers(0, 256, (64, 64, 3)).astype(np.uint8)
                  for i in range(3)]
        p = tnns.parse_launch(
            "datasrc name=s ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 acceleration=pallas device=cpu ! "
            f"tensor_filter framework=torch name=f model={path} "
            f"custom=builder=mobilenet_v2:build_quantized,int8_head=1,compile_cache=2,donate=1,"
            f"{BUILDER_KW} ! tensor_sink name=out collect=true")
        p["s"].data = [torch.from_numpy(f) for f in frames]
        p.run(timeout=120)
        direct = tm.build_quantized(params=params, int8_head=True, device="cpu", **KW)
        assert p["f"].backend._cache_size == 2
        from nnstreamer_tpu_torch.ops import kernels as K

        ops = [("typecast", np.dtype(np.float32)), ("add", -127.5), ("div", 127.5)]
        for f, out in zip(frames, p["out"].frames):
            want = direct(K.fused_arith(torch.from_numpy(f), ops))
            assert torch.equal(out.tensor(0), want)

    def test_full_int8_builder_calibrates_when_opened(self, jax_checkpoint):
        """``int8_convs=1,static_scales=1,calib_samples=2`` reach the
        built-in builder as ints: the model is calibrated and every int8
        conv's operands prepared by ``open``, before negotiation, so the
        filter's capture only reads them; invoking changes no scale."""
        from nnstreamer_tpu_torch.ops import quant as tq

        path, params = jax_checkpoint
        be = TorchBackend()
        be.open(path, f"builder=mobilenet_v2:build_quantized,int8_convs=1,static_scales=1,"
                      f"calib_samples=2,{BUILDER_KW}")
        expand = be.model.params["blocks"][1]["expand"]["conv"]
        assert type(expand["act_scale"]) is float and expand["int8"].act_scale == expand["act_scale"]
        assert not tq.is_calibrating()
        direct = tm.build_quantized(params=params, int8_convs=True, static_scales=True,
                                    calib_samples=2, device="cpu", **KW)
        assert expand["act_scale"] == direct.params["blocks"][1]["expand"]["conv"]["act_scale"]
        prepared = expand["int8"]
        be.reconfigure(TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(64, 64, 3))))
        x = _frames(4, n=1)[0]
        got = be.invoke((torch.from_numpy(x),))[0]
        assert expand["int8"] is prepared
        assert torch.equal(got, direct(torch.from_numpy(x)))

    def test_reserved_keys_are_not_builder_kwargs(self, tmp_path, jax_checkpoint):
        path, _ = jax_checkpoint
        builder = tmp_path / "builder.py"
        builder.write_text(textwrap.dedent("""
            from nnstreamer_tpu_torch.backends.torch_backend import TorchModel

            def make(params):
                return TorchModel(apply=lambda p, x: x + float(p["classifier"]["b"].sum()),
                                  params=params, device="cpu", name="from_file")
        """))
        be = TorchBackend()
        be.open(path, f"builder={builder}:make,compile_cache=3,donate=1")
        assert be.model.name == "from_file" and be._cache_size == 3
        kwargs = __import__("nnstreamer_tpu_torch.backends.torch_backend", fromlist=["x"]) \
            ._builder_kwargs({"builder": "b", "compile_cache": "3", "donate": "1", "a": "1",
                              "b": "2.5", "c": "x"}, TorchBackend.RESERVED_CUSTOM_KEYS)
        assert kwargs == {"a": 1, "b": 2.5, "c": "x"}

    def test_checkpoint_without_builder_raises(self, jax_checkpoint):
        with pytest.raises(ValueError, match="builder"):
            TorchBackend().open(jax_checkpoint[0], "")

    def test_unloadable_path_raises(self, tmp_path):
        with pytest.raises(ValueError, match="cannot load"):
            TorchBackend().open(str(tmp_path / "missing.pt"))


JAX_PY_MODEL = """
import numpy as np
from nnstreamer_tpu.backends.jax_backend import JaxModel
from nnstreamer_tpu.spec import TensorSpec, TensorsSpec

def get_model(custom=""):
    scale = float(custom or 2)
    return JaxModel(apply=lambda p, x: x * scale,
                    input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(None, 4))))
"""

PORT_PY_MODEL = """
import numpy as np
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.conf import conf
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

def get_model(custom=""):
    scale = float(custom or 2)
    return TorchModel(apply=lambda p, x: x * scale, device=conf.get("filter", "torch_device"),
                      input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(None, 4))))
"""


def _pipeline_outputs(nns, desc, frames, wrap):
    p = nns.parse_launch(desc)
    p["s"].data = [wrap(f) for f in frames]
    p.run(timeout=120)
    return [np.asarray(f.tensors[0]) for f in p["out"].frames], p


class TestFileModels:
    @pytest.mark.parametrize("custom", ["", "0.1"])
    def test_py_model_file(self, tmp_path, custom):
        (tmp_path / "jax_model.py").write_text(JAX_PY_MODEL)
        (tmp_path / "port_model.py").write_text(PORT_PY_MODEL)
        frames = [np.random.default_rng(i).standard_normal((3, 4)).astype(np.float32)
                  for i in range(3)]
        tail = f" custom={custom}" if custom else ""
        want, _ = _pipeline_outputs(
            jnns, f"datasrc name=s ! tensor_filter framework=jax model={tmp_path}/jax_model.py"
                  f"{tail} ! tensor_sink name=out collect=true", frames, lambda f: f)
        got, p = _pipeline_outputs(
            tnns, f"datasrc name=s ! tensor_filter framework=torch name=f "
                  f"model={tmp_path}/port_model.py{tail} ! tensor_sink name=out collect=true",
            frames, torch.from_numpy)
        assert p["f"].backend.device.type == "cpu"
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_py_model_must_return_a_torch_model(self, tmp_path):
        (tmp_path / "bad.py").write_text("def get_model():\n    return lambda x: x\n")
        with pytest.raises(TypeError, match="TorchModel"):
            TorchBackend().open(str(tmp_path / "bad.py"))
        (tmp_path / "none.py").write_text("X = 1\n")
        with pytest.raises(ValueError, match="get_model"):
            TorchBackend().open(str(tmp_path / "none.py"))

    def test_torchscript_file(self, tmp_path):
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.ReLU(), torch.nn.Linear(6, 3))
        path = str(tmp_path / "net.pt")
        torch.jit.trace(net.eval(), torch.zeros(2, 4)).save(path)
        frames = [np.random.default_rng(i).standard_normal((2, 4)).astype(np.float32)
                  for i in range(3)]
        want, _ = _pipeline_outputs(
            jnns, f"datasrc name=s ! tensor_filter framework=torch model={path} ! "
                  "tensor_sink name=out collect=true", frames, lambda f: f)
        got, p = _pipeline_outputs(
            tnns, f"datasrc name=s ! tensor_filter framework=torch name=f model={path} ! "
                  "tensor_sink name=out collect=true", frames, torch.from_numpy)
        be = TorchBackend()
        be.open(path)
        assert be.model_spec() is None and isinstance(be.model.apply, torch.jit.ScriptModule)
        assert be.model.device.type == "cpu"
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_torch_cpu_is_pinned_to_the_cpu(self, tmp_path, monkeypatch):
        monkeypatch.setenv("NNSTPU_FILTER_TORCH_DEVICE", "cuda")
        (tmp_path / "port_model.py").write_text(PORT_PY_MODEL.replace(
            'device=conf.get("filter", "torch_device")', 'device="cpu"'))
        be = get_backend("torch-cpu")
        be.open(str(tmp_path / "port_model.py"))
        assert be.name == "torch-cpu" and be.device.type == "cpu"
        be = get_backend("torch-cpu")
        be.open(lambda x: x + 1)  # a callable lives on the pinned device
        assert be.device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="pinned"):
            get_backend("torch-cpu").open(TorchModel(apply=lambda p, x: x, device="cuda"))

    def test_file_models_default_to_the_card(self, tmp_path, monkeypatch):
        monkeypatch.delenv("NNSTPU_FILTER_TORCH_DEVICE")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        (tmp_path / "port_model.py").write_text(PORT_PY_MODEL)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            TorchBackend().open(str(tmp_path / "port_model.py"))


class TestPreOpenedBackend:
    def test_start_keeps_a_loaded_backend_and_its_captures(self):
        from test_torch_drift import GraphCapture

        be = TorchBackend()
        be.capture = GraphCapture()
        be.open(TorchModel(apply=lambda p, x: x * 3, device="cpu"))
        spec = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(2, 4)))
        be.reconfigure(spec)  # warm: one capture before the pipeline
        p = tnns.Pipeline()
        src = p.add(tnns.make("datasrc", data=[torch.ones(2, 4)] * 2))
        filt = p.add(tnns.make("tensor_filter", backend=be))
        sink = p.add(tnns.make("tensor_sink", collect=True))
        p.link_chain(src, filt, sink)
        p.run(timeout=30)
        assert be.stats["captures"] == 1 and be.stats["hits"] == 1
        assert be.stats["replays"] == 2
        assert torch.equal(sink.frames[0].tensor(0), torch.full((2, 4), 3.0))

    def test_capture_failure_still_names_the_op(self, tmp_path):
        (tmp_path / "port_model.py").write_text(PORT_PY_MODEL)
        be = TorchBackend()

        def refusing(fn, in_spec, device):
            raise RuntimeError("operation not permitted when stream is capturing")

        be.capture = refusing
        be.open(str(tmp_path / "port_model.py"))
        with pytest.raises(NegotiationError, match="cannot be captured"):
            be.reconfigure(TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(2, 4))))


# -- custom, custom-python, custom-easy ----------------------------------------

EXAMPLES = REPO / "nnstreamer_tpu_torch" / "examples" / "custom_filters"
JAX_EXAMPLES = REPO / "examples" / "custom_filters"


def _filter_run(nns, frames, wrap, **filter_props):
    p = nns.Pipeline()
    src = p.add(nns.make("datasrc", data=[wrap(f) for f in frames]))
    filt = p.add(nns.make("tensor_filter", **filter_props))
    sink = p.add(nns.make("tensor_sink", collect=True))
    p.link_chain(src, filt, sink)
    p.run(timeout=60)
    return [np.asarray(f.tensors[0]) for f in sink.frames], filt


class TestCustomFilters:
    @pytest.mark.parametrize("name,custom", [("scaler", "224x224"), ("scaler", ""),
                                             ("passthrough", ""), ("average", "")])
    def test_example_filter_matches_the_reference(self, name, custom):
        """The port's example filter in a port pipeline, the JAX package's
        in a JAX pipeline, on the same 640x480 frames: bit for bit."""
        frames = [np.random.default_rng(i).integers(0, 256, (480, 640, 3)).astype(np.uint8)
                  for i in range(2)]
        want, _ = _filter_run(jnns, frames, lambda f: f, framework="custom-python",
                              model=str(JAX_EXAMPLES / f"{name}.py"), custom=custom)
        got, filt = _filter_run(tnns, frames, torch.from_numpy, framework="custom-python",
                                model=str(EXAMPLES / f"{name}.py"), custom=custom)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        if name == "scaler" and custom:
            assert got[0].shape == (224, 224, 3)
            assert filt.src_pads["src"].spec.tensors[0].shape == (224, 224, 3)

    def test_custom_callable_probed_on_zeros(self):
        frames = [np.arange(6, dtype=np.int16).reshape(2, 3) + i for i in range(2)]
        want, _ = _filter_run(jnns, frames, lambda f: f, framework="custom",
                              model=lambda x: x * 3)
        seen = []

        def fn(x):
            seen.append((x.dtype, tuple(x.shape), x.device.type))
            return x * 3

        got, filt = _filter_run(tnns, frames, torch.from_numpy, framework="custom", model=fn)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert seen[0] == (torch.int16, (2, 3), "cpu")  # the probe: zeros on the CPU
        assert filt.src_pads["src"].spec.tensors[0].dtype == np.int16

    def test_custom_object_drops_frames_and_returns_numpy(self):
        class Filter(tcustom.CustomFilterBase):
            def __init__(self):
                self.n = 0

            def get_input_spec(self):
                return TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(3,)))

            def get_output_spec(self):
                return self.get_input_spec()

            def invoke(self, x):
                self.n += 1
                return () if self.n % 2 == 0 else np.asarray(x) + 1  # numpy: a host tensor

        frames = [np.full(3, i, np.float32) for i in range(4)]
        got, _ = _filter_run(tnns, frames, torch.from_numpy, framework="custom", model=Filter())
        assert [g.tolist() for g in got] == [[1.0] * 3, [3.0] * 3]

    def test_custom_easy(self):
        ins = JTensorsSpec.of(JTensorSpec(dtype=np.float32, shape=(4,)))
        tins = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(4,)))
        jcustom.register_custom_easy("neg_sq", lambda x: -(x * x), ins, ins)
        tcustom.register_custom_easy("neg_sq", lambda x: -(x * x), tins, tins)
        try:
            frames = [np.linspace(-2, 2, 4, dtype=np.float32) + i for i in range(2)]
            want, _ = _filter_run(jnns, frames, lambda f: f, framework="custom-easy",
                                  model="neg_sq")
            got, filt = _filter_run(tnns, frames, torch.from_numpy, framework="custom-easy",
                                    model="neg_sq")
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        finally:
            jcustom.unregister_custom_easy("neg_sq")
            tcustom.unregister_custom_easy("neg_sq")
        with pytest.raises(ValueError, match="no custom-easy filter"):
            get_backend("custom-easy").open("neg_sq")

    def test_custom_python_needs_a_custom_filter_class(self, tmp_path):
        (tmp_path / "f.py").write_text("X = 1\n")
        with pytest.raises(ValueError, match="CustomFilter"):
            get_backend("custom-python").open(str(tmp_path / "f.py"))
        with pytest.raises(TypeError, match="lacks invoke"):
            get_backend("custom").open(object())

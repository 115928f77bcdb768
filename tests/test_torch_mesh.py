"""The port's device mesh and batch-sharded dispatch against the JAX package's.

Case for case with the JAX package's ``tests/test_mesh.py``: the spec
grammar and its activation from the environment and from ``[mesh] spec``,
the clamp, the mesh's cache key, ``mesh_bucket``, sharded dispatch equal
to the reference's unsharded run (an affine model; MobileNet-v2 0.35 at
96x96 with the int8 head at batch 8, whose one activation scale must stay
the whole batch's), the fallback of a geometry the mesh does not divide,
captures keyed by mesh, ``tensor_dynbatch`` under the mesh end to end, the
device tracer's series a shard, chained sharded filters, the query
server's group sizing and the ``torch-sharded`` backend.

The port's mesh is 8 CPU devices (``force_device_count(8, "cpu")``), the
counterpart of the 8 virtual CPU devices ``tests/conftest.py`` gives JAX.
The port reads ``NNSTPU_MESH`` through its own conf, which each test gives
a copy of the environment, so the JAX package in the same process stays
unsharded unless a test sets the real variable for it.  Captures on the
CPU are stand-ins (``TorchBackend.capture`` / ``capture_sharded``) whose
entries run the function eagerly, as the card's replays run the captured
one.

Tolerances: float32 outputs of the affine model within 2 ulps of the
largest reference output (the two sides round the same four products in
their own order: the reference's own sharded and unsharded runs lie an ulp
apart);
the int8 head at 1e-2 of the largest logit with top-1 equal (features within ~1e-5
of each other can quantize one int8 step apart, as in
``tests/test_torch_batch.py``).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.jax_backend import JaxBackend, JaxModel
from nnstreamer_tpu.elements.dynbatch import mesh_bucket as jmesh_bucket
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.parallel import mesh as jmesh
from nnstreamer_tpu.spec import TensorsSpec as JSpecs
from nnstreamer_tpu_torch import conf as tconf
from nnstreamer_tpu_torch.backends.sharded import run_eager
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend, TorchModel
from nnstreamer_tpu_torch.elements.dynbatch import DynBatch, DynUnbatch, mesh_bucket
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.query import QueryServer
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.obs import spans
from nnstreamer_tpu_torch.obs import util as tutil
from nnstreamer_tpu_torch.parallel import mesh as pmesh
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

NDEV = 8


@pytest.fixture(autouse=True)
def env(monkeypatch):
    """Mesh mode off, a cold spec cache and 8 CPU devices for the port; the
    port's conf reads this copy of the environment."""
    copy = {k: v for k, v in os.environ.items() if not k.startswith("NNSTPU_MESH")}
    monkeypatch.setattr(tconf.conf, "_environ", copy)
    monkeypatch.delenv("NNSTPU_MESH", raising=False)
    monkeypatch.delenv("NNSTPU_MESH_SPEC", raising=False)
    jmesh.reset_dispatch_mesh()
    pmesh.force_device_count(NDEV, "cpu")
    yield copy
    pmesh.force_device_count(None)
    jmesh.reset_dispatch_mesh()
    spans.reset()
    tutil.clear_costs()


def _mesh_on(env, spec="dp:8"):
    env["NNSTPU_MESH"] = spec
    pmesh.reset_dispatch_mesh()


def _affine(batch=None):
    w = np.arange(16, dtype=np.float32).reshape(4, 4) / 7.0
    spec = TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(batch, 4)))
    port = TorchModel(apply=lambda p, x: x @ p["w"] + 1.5, params={"w": torch.from_numpy(w)},
                      input_spec=spec, name="affine", device="cpu")
    ref = JaxModel(apply=lambda p, x: x @ p["w"] + 1.5, params={"w": w},
                   input_spec=JSpecs.of(jnns.spec.TensorSpec(dtype=np.float32,
                                                             shape=(batch, 4))),
                   name="affine")
    return port, ref, w


def _ulps(got, want, n=2):
    """Within ``n`` float32 ulps of the largest reference output."""
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= n * float(np.spacing(np.abs(want).max()))


def _jax_invoke(model, x):
    b = JaxBackend()
    b.open(model)
    b.reconfigure(JSpecs.from_arrays((x,)))
    (out,) = b.invoke((x,))
    return np.asarray(out)


def _port_backend(model, x, cls=TorchBackend, custom=""):
    b = cls()
    b.open(model, custom)
    b.reconfigure(TensorsSpec.from_arrays((torch.from_numpy(x),)))
    return b


class _Entry:
    """A capture stand-in: its run calls the function eagerly."""

    warmup_calls = 0

    def __init__(self, fn):
        self.fn = fn

    def run(self, xs):
        return tuple(self.fn(*xs)) if isinstance(self.fn(*xs), tuple) else (self.fn(*xs),)


class _ShardedEntry:
    """A sharded capture stand-in: its run is the eager sharded call."""

    warmup_calls = 0

    def __init__(self, fns, devs):
        self.fns, self.devs = fns, devs
        self.last_shard_events = None

    def run(self, xs, timing=False):
        return run_eager(self.fns, xs, self.devs)[0]


def _fake_captures(monkeypatch):
    monkeypatch.setattr(TorchBackend, "capture", staticmethod(lambda fn, spec, dev: _Entry(fn)))
    monkeypatch.setattr(TorchBackend, "capture_sharded", staticmethod(
        lambda fns, spec, devs: _ShardedEntry(fns, devs)))


# -- the spec --------------------------------------------------------------------


class TestMeshSpec:
    SPELLINGS = ["", "off", "0", "1", "auto", "dp:8", "data", "4", "DP:2", "none", "sp:3"]

    @pytest.mark.parametrize("spec", SPELLINGS)
    def test_parse_equals_the_reference(self, spec):
        assert pmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)

    def test_parse_variants(self):
        assert pmesh.parse_mesh_spec("") == ("dp", 1)
        assert pmesh.parse_mesh_spec("auto") == ("dp", 0)
        assert pmesh.parse_mesh_spec("dp:8") == ("dp", 8)
        assert pmesh.parse_mesh_spec("data") == ("data", 0)
        assert pmesh.parse_mesh_spec("DP:2") == ("dp", 2)
        for parse in (pmesh.parse_mesh_spec, jmesh.parse_mesh_spec):
            with pytest.raises(ValueError):
                parse("dp:eight")

    def test_off_by_default(self):
        assert pmesh.dispatch_mesh() is None
        assert pmesh.dispatch_mesh_devices() == 1
        assert pmesh.dispatch_mesh_axis() == "dp"

    def test_env_activation_and_clamp(self, env):
        _mesh_on(env, "dp:8")
        mesh = pmesh.dispatch_mesh()
        assert mesh is not None and mesh.size == 8 and pmesh.dispatch_mesh_devices() == 8
        assert pmesh.dispatch_mesh_axis() == "dp"
        _mesh_on(env, "dp:64")  # more than the process has: clamped
        assert pmesh.dispatch_mesh().size == NDEV
        _mesh_on(env, "auto")
        assert pmesh.dispatch_mesh().size == NDEV
        _mesh_on(env, "data:4")
        assert pmesh.dispatch_mesh_axis() == "data" and pmesh.dispatch_mesh_devices() == 4
        _mesh_on(env, "dp:1")
        assert pmesh.dispatch_mesh() is None
        pmesh.force_device_count(None)  # the real devices: one CPU, so no mesh
        _mesh_on(env, "dp:4")
        assert pmesh.visible_devices() == [torch.device("cpu")]
        assert pmesh.dispatch_mesh() is None and pmesh.dispatch_mesh_devices() == 1

    def test_conf_ini_form(self, env, tmp_path):
        env["NNSTPU_MESH_SPEC"] = "dp:4"
        pmesh.reset_dispatch_mesh()
        assert pmesh.dispatch_mesh().size == 4
        env["NNSTPU_MESH"] = "dp:2"  # the short spelling wins
        pmesh.reset_dispatch_mesh()
        assert pmesh.dispatch_mesh().size == 2
        del env["NNSTPU_MESH"], env["NNSTPU_MESH_SPEC"]
        ini = tmp_path / "nnstreamer_tpu.ini"
        ini.write_text("[mesh]\nspec = dp:8\n")
        conf = tconf.Conf(ini_path=str(ini), environ=env)
        assert conf.get("mesh", "spec") == "dp:8"
        assert tconf.DEFAULTS["mesh"]["spec"] == ""

    def test_mesh_cache_key_identity(self):
        m8 = pmesh.make_mesh((8,), ("dp",))
        m4 = pmesh.make_mesh((4,), ("dp",))
        assert pmesh.mesh_cache_key(None) is None
        assert pmesh.mesh_cache_key(m8) == pmesh.mesh_cache_key(pmesh.make_mesh((8,), ("dp",)))
        assert pmesh.mesh_cache_key(m8) != pmesh.mesh_cache_key(m4)
        assert pmesh.mesh_cache_key(m8) != pmesh.mesh_cache_key(pmesh.make_mesh((8,), ("ep",)))

    def test_make_mesh_refuses_more_devices_than_exist(self):
        for make in (pmesh.make_mesh, jmesh.make_mesh):
            with pytest.raises(ValueError, match="needs 64 devices"):
                make((64,), ("dp",))


class TestCollectives:
    """The list collectives against their numpy definitions (``jax.lax``
    semantics), exactly."""

    def _shards(self, n=4):
        return [torch.arange(24, dtype=torch.float32).reshape(2, 4, 3) + 100 * i
                for i in range(n)]

    def test_ppermute_rotate_and_zeros(self):
        devs = [torch.device("cpu")] * 4
        xs = self._shards()
        rot = pmesh.rotate(xs, devs)
        assert all(torch.equal(rot[(j + 1) % 4], xs[j]) for j in range(4))
        part = pmesh.ppermute(xs, devs, [(0, 1), (1, 2)])
        assert torch.equal(part[1], xs[0]) and torch.equal(part[2], xs[1])
        assert not part[0].any() and not part[3].any()

    def test_all_to_all_is_the_tiled_exchange(self):
        devs = [torch.device("cpu")] * 4
        xs = self._shards()
        out = pmesh.all_to_all(xs, devs, split_axis=1, concat_axis=0)
        for j in range(4):
            want = np.concatenate([x.numpy()[:, j:j + 1] for x in xs], axis=0)
            np.testing.assert_array_equal(out[j].numpy(), want)
        with pytest.raises(ValueError, match="does not split"):
            pmesh.all_to_all(xs, devs, split_axis=2, concat_axis=0)

    def test_gather_reduce_and_placement(self):
        devs = [torch.device("cpu")] * 4
        xs = self._shards()
        whole = torch.cat(xs)
        assert all(torch.equal(g, whole) for g in pmesh.all_gather(xs, devs))
        assert all(torch.equal(r, xs[3]) for r in pmesh.all_reduce(xs, devs, "max"))
        mesh = pmesh.make_mesh((4,), ("dp",))
        sh = pmesh.batch_sharding(mesh, 3).place(whole)
        assert len(sh.shards) == 4 and torch.equal(sh.gather(), whole)
        assert pmesh.batch_sharding(mesh, 3).device_set == {f"cpu:{i}" for i in range(4)}
        rep = pmesh.replicated(mesh).place(whole)
        assert len(rep.shards) == 4 and torch.equal(rep.gather(), whole)


# -- mesh_bucket -------------------------------------------------------------------


class TestMeshBucket:
    def test_single_device_ladder(self):
        assert [mesh_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]

    def test_per_shard_ladder(self):
        assert mesh_bucket(1, 8, 8) == 8
        assert mesh_bucket(9, 8, 8) == 16
        assert mesh_bucket(33, 8, 8) == 64
        assert mesh_bucket(100, 8, 8) == 64  # capped at ndev x max_batch
        assert all(mesh_bucket(n, 8, 8) % 8 == 0 for n in range(1, 70))

    @pytest.mark.parametrize("max_batch", [1, 2, 8])
    @pytest.mark.parametrize("ndev", [1, 2, 4, 8])
    def test_equals_the_reference(self, max_batch, ndev):
        assert [mesh_bucket(n, max_batch, ndev) for n in range(1, 65)] == \
            [jmesh_bucket(n, max_batch, ndev) for n in range(1, 65)]


# -- sharded dispatch in the backend -------------------------------------------


class TestMeshBackend:
    def test_sharded_matches_single_device(self, env):
        port, ref, w = _affine()
        x = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)
        want = _jax_invoke(ref, x)
        _mesh_on(env, "dp:8")
        b = _port_backend(port, x)
        assert b._mesh is not None and b.mesh_devices() == 8
        (out,) = b.invoke((torch.from_numpy(x),))
        assert [lb for lb, _ in b.last_shards] == [f"cpu:{i}" for i in range(8)]
        _ulps(out.numpy(), want)
        np.testing.assert_allclose(want, x @ w + 1.5, rtol=1e-5)
        (eager,) = b.eager(torch.from_numpy(x))  # the reference call runs sharded too
        assert torch.equal(eager, out)

    def test_int8_head_keeps_the_batch_scale(self, env, monkeypatch):
        """Config 5's int8 head under ``dp:4``: each shard's ``int8_matmul``
        takes the whole batch's activation scale (the shards' maxima
        reduced), as the reference computes on its 8-device mesh, where its
        sharded logits equal its unsharded ones bit for bit.  Rows scaled
        so that the shards' maxima differ: the port's sharded rows equal
        its unsharded ones within 1e-5 of the largest logit (0 measured on
        the CPU), and a per-shard scale (the control) moves some row by
        more than 5% of that row's largest logit (about 9% here)."""
        tree = tm.init_tree(0, 10, 0.35)
        kw = dict(num_classes=10, width_mult=0.35, image_size=96, params=tree, int8_head=True)
        rng = np.random.default_rng(5)
        scale = np.array([1, 1, 1e-3, 1e-3, 3e-3, 3e-3, 1e-2, 1e-2], np.float32)
        x = rng.uniform(-1, 1, (8, 96, 96, 3)).astype(np.float32) * scale[:, None, None, None]
        jmodel = jm.build_quantized(**kw, batch=8, dtype=jnp.float32)
        want = _jax_invoke(jmodel, x)
        monkeypatch.setenv("NNSTPU_MESH", "dp:8")  # the reference on its 8 CPU devices
        jmesh.reset_dispatch_mesh()
        want_mesh = _jax_invoke(jmodel, x)
        monkeypatch.delenv("NNSTPU_MESH")
        jmesh.reset_dispatch_mesh()
        np.testing.assert_array_equal(want_mesh, want)
        tmodel = tm.build_quantized(**kw, batch=8, dtype=torch.float32, device="cpu")
        _mesh_on(env, "dp:4")
        b = _port_backend(tmodel, x)
        assert b._mesh is not None and b._mesh.size == 4
        (got,) = b.invoke((torch.from_numpy(x),))
        top = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= 1e-2 * top
        assert (got.numpy().argmax(-1) == want.argmax(-1)).all()
        whole = tmodel(torch.from_numpy(x)).numpy()  # the port unsharded: one scale
        assert float(np.abs(got.numpy() - whole).max()) <= 1e-5 * top
        control = torch.cat([tmodel(torch.from_numpy(x[2 * i:2 * i + 2])) for i in range(4)])
        per_row = np.abs(control.numpy() - want).max(-1) / np.abs(want).max(-1)
        assert per_row.max() > 5e-2  # a shard's own scale moves its rows far more

    def test_unshardable_geometry_falls_back(self, env):
        port, _, w = _affine()
        _mesh_on(env, "dp:8")
        x = np.ones((3, 4), np.float32)  # 3 does not divide 8
        b = _port_backend(port, x)
        assert b._mesh is None
        (out,) = b.invoke((torch.from_numpy(x),))
        assert b.last_shards is None
        np.testing.assert_allclose(out.numpy(), x @ w + 1.5, rtol=1e-6)

    def test_captures_keyed_by_mesh(self, env, monkeypatch):
        """One capture a (geometry, mesh); repeats replay it; the same
        geometry under a mesh is another capture; back off the mesh, the
        single-device one is selected again (a hit)."""
        _fake_captures(monkeypatch)
        port, _, w = _affine()
        x = torch.ones((16, 4))
        b = _port_backend(port, x.numpy())
        spec = TensorsSpec.from_arrays((x,))
        for _ in range(5):
            b.invoke((x,))
        assert b.stats["captures"] == 1 and b.stats["replays"] == 5
        _mesh_on(env, "dp:8")
        b.reconfigure(spec)
        assert b._mesh is not None and isinstance(b._entry, _ShardedEntry)
        for _ in range(5):
            (out,) = b.invoke((x,))
        assert b.stats["captures"] == 2
        np.testing.assert_allclose(out.numpy(), x.numpy() @ w + 1.5, rtol=1e-6)
        del env["NNSTPU_MESH"]
        pmesh.reset_dispatch_mesh()
        b.reconfigure(spec)
        assert b.stats["captures"] == 2 and b.stats["hits"] >= 1
        assert isinstance(b._entry, _Entry)

    def test_wire_rule_and_upload_sharding(self, env):
        """The wire keeps the logical shape either way; with a mesh the
        backend names the batch sharding, which ``tensor_upload`` asks for
        and which splits a batch into the 8 shards."""
        port = TorchModel(apply=lambda p, x: x * 2.0, device="cpu",
                          input_spec=TensorsSpec.of(TensorSpec(np.float32, (16, 4, 4))))
        b = TorchBackend()
        b.open(port)
        assert b._wire_shape((16, 4, 4)) == (16, 4, 4)
        assert b.wire_input_sharding(0) is None
        _mesh_on(env, "dp:8")
        b.reconfigure(TensorsSpec.of(TensorSpec(np.float32, (16, 4, 4))))
        assert b._wire_shape((16, 4, 4)) == (16, 4, 4)
        sh = b.wire_input_sharding(0)
        assert sh is not None and len(sh.device_set) == 8 and sh.spec == ("dp", None, None)
        x = torch.arange(256, dtype=torch.float32).reshape(16, 4, 4)
        placed = sh.place(x)
        assert len(placed.shards) == 8 and torch.equal(placed.gather(), x)
        p = tnns.parse_launch("datasrc name=s ! tensor_upload name=u ! queue ! "
                              "tensor_filter framework=torch name=f ! tensor_sink name=out")
        p["s"].data = [x]
        p["f"].model = port
        p.start()
        try:
            assert p.wait(60)
            assert p["u"]._sharding_for(0).spec == ("dp", None, None)
        finally:
            p.stop()

    def test_torch_sharded_backend(self, env):
        """``framework=torch-sharded custom=devices=4,axis=dp``: its own
        mesh without ``NNSTPU_MESH``, equal to the reference; a batch its
        mesh does not divide raises."""
        port, ref, w = _affine()
        x = np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32)
        from nnstreamer_tpu_torch.backends.torch_backend import TorchShardedBackend

        b = _port_backend(port, x, TorchShardedBackend, "devices=4,axis=dp")
        assert b.mesh_devices() == 4 and b._mesh.axis_names == ("dp",)
        (out,) = b.invoke((torch.from_numpy(x),))
        _ulps(out.numpy(), _jax_invoke(ref, x))
        assert len(b.last_shards) == 4
        with pytest.raises(ValueError, match="does not split"):
            b.invoke((torch.ones(6, 4),))
        got = []
        p = tnns.parse_launch("datasrc name=s ! tensor_filter framework=torch-sharded name=f "
                              "custom=devices=2,axis=dp ! tensor_sink name=out")
        p["s"].data = [torch.from_numpy(x)]
        p["f"].model = port
        p["out"].connect("new-data", lambda f: got.append(f.tensors[0]))
        p.run(timeout=60)
        np.testing.assert_allclose(got[0].numpy(), x @ w + 1.5, rtol=1e-5)
        with pytest.raises(ValueError, match="needs 16 devices"):
            _port_backend(port, np.ones((16, 4), np.float32), TorchShardedBackend,
                          "devices=16")


class TestCaptureAcrossCards:
    """The in-model modes are captured where their mesh lies on one device
    (the card's case, and the forced meshes); a mesh that spans cards runs
    the function eagerly there (untried on more than one card)."""

    def test_on_one_device(self):
        one = pmesh.make_mesh((4,), ("sp",), [torch.device("cuda", 0)] * 4)
        two = pmesh.make_mesh((2,), ("sp",), [torch.device("cuda", 0), torch.device("cuda", 1)])
        assert pmesh.on_one_device(None) and pmesh.on_one_device(one, None)
        assert not pmesh.on_one_device(two) and not pmesh.on_one_device(one, two)

    def test_builders_mark_a_mesh_across_cards(self, monkeypatch):
        from nnstreamer_tpu_torch.models import transformer, vit

        two = pmesh.make_mesh((2,), ("sp",), [torch.device("cuda", 0), torch.device("cuda", 1)])
        kw = dict(d_model=16, n_heads=2, n_layers=2, device="cpu")
        assert transformer.build(seq_len=4, d_in=4, **kw).capturable
        assert transformer.build(seq_len=4, d_in=4, attn="ring",
                                 mesh=pmesh.make_mesh((4,), ("sp",)), **kw).capturable
        # (an MoE or a pipelined build places its weights on the mesh's cards
        # at build time, which this host has not: on_one_device covers them)
        assert not transformer.build(seq_len=4, d_in=4, attn="ring", mesh=two, **kw).capturable
        assert not vit.build(num_classes=4, image_size=16, patch=8, attn="ulysses", mesh=two,
                             **kw).capturable
        # the backend never captures such a model: it runs it eagerly
        _fake_captures(monkeypatch)
        model = TorchModel(apply=lambda p, x: x + 1.0, device="cpu", capturable=False)
        b = _port_backend(model, np.zeros((4, 2), np.float32))
        (out,) = b.invoke((torch.zeros(4, 2),))
        assert b.stats["captures"] == 0 and b._entry is None and torch.equal(out, torch.ones(4, 2))


# -- the batch elements and the device lane under the mesh ------------------------


def _dyn_run(nns, datasrc, dynbatch, filt, unbatch, sink, model, n_frames, max_batch=4,
             framework="torch", tracer=None, name="mesh_dyn"):
    got = []
    p = nns.Pipeline(name=name)
    src = p.add(datasrc(data=[np.full((4,), i, np.float32) for i in range(n_frames)], name="s"))
    db = p.add(dynbatch(max_batch=max_batch, name="db"))
    f = p.add(filt(framework=framework, model=model, name="f"))
    un = p.add(unbatch(name="un"))
    out = p.add(sink(name="out"))
    out.connect("new-data", got.append)
    p.link_chain(src, db, f, un, out)
    if tracer is not None:
        p.attach_tracer(tracer)
    p.run(timeout=120)
    return got, db, p


def _poly(fn):
    return TorchModel(apply=lambda p, x: fn(x), device="cpu", name="poly")


class TestDynBatchMesh:
    def _ref(self, n, max_batch=4):
        from nnstreamer_tpu.elements.dynbatch import DynBatch as JDyn, DynUnbatch as JUn
        from nnstreamer_tpu.elements.filter import TensorFilter as JF
        from nnstreamer_tpu.elements.sink import TensorSink as JS
        from nnstreamer_tpu.elements.testsrc import DataSrc as JD

        model = JaxModel(apply=lambda p, x: x * 3.0 + 0.5, input_spec=None)
        got, _, _ = _dyn_run(jnns, JD, JDyn, JF, JUn, JS, model, n, max_batch, "jax")
        return sorted(float(np.asarray(f.tensors[0])[0]) for f in got)

    def test_e2e_equivalent_with_padded_tails(self, env):
        """11 frames never divide 8: every batch pads to the per-shard
        bucket and dynunbatch strips it; the values equal the reference's
        single-device stream."""
        _mesh_on(env, "dp:8")
        got, db, _ = _dyn_run(tnns, DataSrc, DynBatch, TensorFilter, DynUnbatch, TensorSink,
                              _poly(lambda x: x * 3.0 + 0.5), 11)
        assert len(got) == 11 and db._mesh_dev == 8
        vals = sorted(float(f.tensors[0][0]) for f in got)
        assert vals == self._ref(11)
        assert vals == [i * 3.0 + 0.5 for i in range(11)]

    def test_per_device_spans_and_metrics(self, env):
        """One sharded dispatch leaves a ``device_exec`` span on each of the
        8 ``device:cpu:<i>`` rows and 8 ``nnstpu_device_exec_seconds``
        series: the skew between shards is visible a shard."""
        from nnstreamer_tpu_torch.obs.device import DeviceTracer
        from nnstreamer_tpu_torch.obs.export import render_text
        from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry

        _mesh_on(env, "dp:8")
        reg = MetricsRegistry()
        tracer = DeviceTracer(registry=reg)
        got, _, p = _dyn_run(tnns, DataSrc, DynBatch, TensorFilter, DynUnbatch, TensorSink,
                             _poly(lambda x: x + 1.0), 16, max_batch=8, tracer=tracer,
                             name="mesh_obs")
        assert len(got) == 16
        summ = tracer.summary()
        assert summ["dispatches"] >= 1 and summ["dropped"] == 0
        assert summ["completed"] == summ["dispatches"]
        assert sorted(summ["by_device"]) == sorted(f"cpu:{i}" for i in range(8))
        doc = json.loads(json.dumps(spans.chrome_trace(spans.snapshot())))
        events = doc["traceEvents"]
        rows = {e["tid"]: e["args"]["name"] for e in events
                if e.get("ph") == "M" and e["name"] == "thread_name"}
        assert sorted(v for v in rows.values() if v.startswith("device:cpu:")) == \
            sorted(f"device:cpu:{i}" for i in range(8))
        execs = [e for e in events if e.get("ph") == "X" and e["name"] == "device_exec"]
        assert {e["args"]["device"] for e in execs} == {f"cpu:{i}" for i in range(8)}
        assert len(execs) == 8 * summ["dispatches"]
        series = [ln for ln in render_text(reg).splitlines()
                  if ln.startswith("nnstpu_device_exec_seconds_count")]
        assert len(series) == 8 and any('device="cpu:7"' in ln for ln in series)

    def test_capture_once_per_bucket_no_frame_churn(self, env, monkeypatch):
        """A steady stream through a mesh dynbatch captures once a (bucket,
        mesh): buckets 8 x {1, 2, 4} at most, whatever the 48 frames, beside
        the geometry negotiated before the first frame (a batch of 1, which
        the mesh does not divide)."""
        captured = []
        monkeypatch.setattr(TorchBackend, "capture", staticmethod(
            lambda fn, spec, dev: captured.append(spec.tensors[0].shape) or _Entry(fn)))
        monkeypatch.setattr(TorchBackend, "capture_sharded", staticmethod(
            lambda fns, spec, devs: captured.append(
                (len(devs) * spec.tensors[0].shape[0],) + tuple(spec.tensors[0].shape[1:]))
            or _ShardedEntry(fns, devs)))
        _mesh_on(env, "dp:8")
        got, _, p = _dyn_run(tnns, DataSrc, DynBatch, TensorFilter, DynUnbatch, TensorSink,
                             _poly(lambda x: x * 3.0 + 0.5), 48)
        assert len(got) == 48
        assert p["f"].backend.stats["captures"] == len(captured)
        batches = sorted(shape[0] for shape in captured)
        assert len(batches) == len(set(batches))  # no geometry captured twice
        assert {8, 16, 32} & set(batches) and set(batches) <= {1, 8, 16, 32}
        assert sorted(float(f.tensors[0][0]) for f in got) == [i * 3.0 + 0.5 for i in range(48)]

    def test_warmup_plan_is_the_mesh_ladder(self, env):
        _mesh_on(env, "dp:4")
        p = tnns.parse_launch("datasrc name=s ! tensor_dynbatch name=db max_batch=4 ! "
                              "tensor_filter framework=torch name=f ! tensor_dynunbatch ! "
                              "tensor_sink name=out")
        p["s"].data = [torch.zeros(4)]
        p["f"].model = _poly(lambda x: x)
        p.start()
        try:
            assert p.wait(60)
            assert [label for label, _ in p["db"].warmup_plan()] == \
                ["bucket4", "bucket8", "bucket16"]
        finally:
            p.stop()


class TestChainedMeshFilters:
    def test_device_resident_hop_between_sharded_filters(self, env):
        """mux → batch → filter → unbatch → batch → filter → unbatch →
        demux, both filters sharded over the mesh: the reference's values."""
        _mesh_on(env, "dp:8")
        n = 8
        got = []
        srcs = " ".join(f"datasrc name=s{i} ! m.sink_{i}" for i in range(n))
        sinks = " ".join(f"d.src_{i} ! tensor_sink name=o{i}" for i in range(n))
        p = tnns.parse_launch(
            f"tensor_mux name=m sync_mode=nosync ! tensor_batch ! tensor_filter "
            f"framework=torch name=f1 ! tensor_unbatch ! tensor_batch ! tensor_filter "
            f"framework=torch name=f2 ! tensor_unbatch ! tensor_demux name=d {srcs} {sinks}")
        for i in range(n):
            p[f"s{i}"].data = [torch.full((4,), float(i)) for _ in range(4)]
            p[f"o{i}"].connect("new-data", got.append)
        p["f1"].model = _poly(lambda x: x + 1.0)
        p["f2"].model = _poly(lambda x: x * 2.0)
        p.start()
        try:
            assert p.wait(120)
            assert p["f1"].backend._mesh is not None and p["f2"].backend._mesh is not None
        finally:
            p.stop()
        assert len(got) == 4 * n
        assert sorted({float(f.tensors[0][0]) for f in got}) == [(i + 1.0) * 2.0
                                                                 for i in range(n)]


class TestQueryMeshSizing:
    @staticmethod
    def _server(**kw):
        model = TorchModel(apply=lambda p, x: x * 2.0, device="cpu",
                           input_spec=TensorsSpec.of(TensorSpec(np.float32, (None, 4))))
        return QueryServer(framework="torch", model=model, device="cpu", batch=2,
                           batch_window_ms=1.0, **kw)

    def test_group_spans_all_shards_in_one_dispatch(self, env):
        """20 rows: one device would split them at 4; the mesh's chunk is
        4 x 8 = 32, so the group dispatches once, padded to 32 rows."""
        _mesh_on(env, "dp:8")
        with self._server(max_batch=4) as srv:
            assert srv.stats()["mesh_devices"] == 8
            xs = [torch.arange(r * 4, dtype=torch.float32).reshape(r, 4) for r in (12, 8)]
            group = [srv._Pending(TensorsSpec.from_arrays((x,)), (x,)) for x in xs]
            srv._dispatch_group(group)
            for g, x in zip(group, xs):
                assert g.error is None, g.error
                assert torch.equal(g.outs[0], 2.0 * x)
            assert srv.batched_invokes == 1 and srv.batched_splits == 0

    def test_oversized_group_still_splits(self, env):
        _mesh_on(env, "dp:2")
        with self._server(max_batch=2) as srv:
            x = torch.arange(36, dtype=torch.float32).reshape(9, 4)
            group = [srv._Pending(TensorsSpec.from_arrays((x,)), (x,))]
            srv._dispatch_group(group)
            assert group[0].error is None
            assert torch.equal(group[0].outs[0], 2.0 * x)
            # the chunk cap is 2 x 2 = 4: 9 rows in 3 dispatches
            assert srv.batched_invokes == 3 and srv.batched_splits == 1

    def test_warmup_ladder_in_mesh_multiples(self, env):
        _mesh_on(env, "dp:4")
        with self._server(max_batch=4) as srv:
            report = srv.warmup(TensorsSpec.of(TensorSpec(np.float32, (4,))))
            assert [c["label"] for c in report["compiled"]] == ["bucket4", "bucket8", "bucket16"]


class TestShardRun:
    """The phase runner behind a sharded dispatch's collectives."""

    def test_collectives_cut_every_shard_at_the_same_point(self):
        from nnstreamer_tpu_torch.backends.sharded import ShardRun

        devs = [torch.device("cpu")] * 4
        seen = []

        def fn(x):
            m = pmesh.reduce_over_batch(x.abs().amax())
            s = pmesh.reduce_over_batch(x.sum(), "sum")
            return x / m + s

        xs = [(torch.full((2,), float(i + 1)),) for i in range(4)]
        run = ShardRun([fn] * 4, xs, devs, begin=lambda i, k: seen.append(("b", i, k)),
                       end=lambda i, k: seen.append(("e", i, k)))
        outs = run.run()
        assert run.segments == 3
        whole = torch.cat([x for (x,) in xs])
        assert torch.equal(torch.cat(outs), whole / whole.abs().amax() + whole.sum())
        # segment k of every shard before segment k + 1 of any
        order = [(k, i) for tag, i, k in seen if tag == "b"]
        assert order == sorted(order)
        assert pmesh.current_shard() is None

    def test_a_failing_shard_stops_the_others(self):
        from nnstreamer_tpu_torch.backends.sharded import ShardRun

        def fn(i):
            m = pmesh.reduce_over_batch(torch.tensor(float(i)))
            if int(i) == 2:
                raise RuntimeError("shard 2 failed")
            return m

        run = ShardRun([fn] * 4, [(torch.tensor(i),) for i in range(4)],
                       [torch.device("cpu")] * 4)
        with pytest.raises(RuntimeError, match="shard 2 failed"):
            run.run()
        assert not [t for t in threading.enumerate() if t.name.startswith("shard:")]

    def test_different_collectives_are_refused(self):
        from nnstreamer_tpu_torch.backends.sharded import ShardRun

        def fn(i):
            return pmesh.reduce_over_batch(i) if int(i) else i

        run = ShardRun([fn] * 2, [(torch.tensor(0),), (torch.tensor(1),)],
                       [torch.device("cpu")] * 2)
        with pytest.raises(RuntimeError, match="different collectives"):
            run.run()
        time.sleep(0)
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("shard:") and t.is_alive()]

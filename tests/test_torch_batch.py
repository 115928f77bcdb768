"""The port's ``tensor_batch`` / ``tensor_unbatch`` against the JAX
package's, on config 5's graph (``bench.py``'s ``run_mux_batched_fps``):

    datasrc×N → tensor_mux sync_mode=nosync → tensor_batch → normalize →
    tensor_upload ! queue → tensor_filter → tensor_unbatch → tensor_demux →
    tensor_sink×N

at a small size: MobileNet-v2 width 0.35 at 96x96, 16 classes, one numpy
tree from seed 0 in both packages (``params_from_jax`` on the port's side),
float32 compute so that the only difference is the convs' summation order
(oneDNN against XLA), which moves logits of magnitude ~1 by ~1e-5: held to
1e-4.  Each stream's frames must arrive in order with their pts.  Then the
pieces: a host batch assembled in a pool lease, the lease recycled and
reused, unbatching to the host and on the device, and the int8 head's per-tensor scale, which
makes a frame's logits depend on the other frames of its batch in both
packages alike.
"""

import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.ops import pallas_kernels as jk
from nnstreamer_tpu.ops import quant as jq
from nnstreamer_tpu_torch import pool as tpool
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.elements.batch import TensorBatch, TensorUnbatch
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.ops.quant import quantize_activations
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

N, SIZE, CLASSES, WIDTH, ROUNDS = 4, 96, 16, 0.35, 3
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
KW = dict(num_classes=CLASSES, width_mult=WIDTH, image_size=SIZE)


@pytest.fixture(scope="module")
def tree():
    return tm.init_tree(0, CLASSES, WIDTH)


def _frames(seed=0, n=N, rounds=ROUNDS, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return [[rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(rounds)]
                for _ in range(n)]
    return [[rng.uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32) for _ in range(rounds)]
            for _ in range(n)]


def _desc(port: bool, n=N, normalize=True):
    srcs = " ".join(f"datasrc name=cam{i} ! m.sink_{i}" for i in range(n))
    sinks = " ".join(f"d.src_{i} ! tensor_sink name=out{i}" for i in range(n))
    norm = (f"tensor_transform mode=arithmetic option={NORMALIZE} acceleration=pallas"
            f"{' device=cpu' if port else ''} ! " if normalize else "")
    return (f"tensor_mux name=m sync_mode=nosync ! tensor_batch ! {norm}"
            "tensor_upload ! queue ! tensor_filter framework={fw} name=f ! tensor_unbatch ! "
            f"tensor_demux name=d {srcs} {sinks}").replace("{fw}", "torch" if port else "jax")


def _run(port: bool, model, frames, normalize=True):
    """Config 5's graph in one package; each stream's (pts, logits) list."""
    n = len(frames)
    p = (tnns if port else jnns).parse_launch(_desc(port, n, normalize))
    for i in range(n):
        p[f"cam{i}"].data = [torch.from_numpy(x) for x in frames[i]] if port else frames[i]
    p["f"].model = model
    got = {i: [] for i in range(n)}
    for i in range(n):
        p[f"out{i}"].connect("new-data", lambda f, i=i: got[i].append(
            (f.pts, np.asarray(f.tensors[0]))))
    p.run(timeout=120)
    return p, got


def _check(got, want, atol):
    assert got.keys() == want.keys()
    for i in want:
        assert len(got[i]) == len(want[i]) == ROUNDS
        assert [pts for pts, _ in got[i]] == [pts for pts, _ in want[i]]
        for (_, g), (_, w) in zip(got[i], want[i]):
            assert g.shape == w.shape == (CLASSES,)
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)


class TestConfig5:
    def test_float_graph_matches_the_reference(self, tree):
        """Config 5 with the normalize folded into the filter in both
        packages: every stream's logits within 1e-4 of the reference's,
        in order, with the reference's pts; and each round equal to the
        port's own model on the stacked, normalized frames."""
        frames = _frames(0)
        jmodel = jm.build(**KW, batch=N, dtype=jnp.float32, params=tree)
        tmodel = tm.build(**KW, batch=N, dtype=torch.float32, params=tree, device="cpu")
        p, got = _run(True, tmodel, frames)
        _, want = _run(False, jmodel, frames)
        assert not any(type(n).__name__ == "TensorTransform" for n in p.nodes.values())
        _check(got, want, atol=1e-4)
        for r in range(ROUNDS):
            x = torch.stack([torch.from_numpy(frames[i][r]) for i in range(N)])
            ref = tmodel(x.float().sub(127.5).mul(1 / 127.5)).numpy()
            for i in range(N):
                np.testing.assert_allclose(got[i][r][1], ref[i], rtol=0, atol=1e-5)


class TestBatchElement:
    SPEC = TensorsSpec(tensors=(TensorSpec(np.uint8, (2, 3)),) * 3)

    def _batch(self, pool):
        b = TensorBatch(pool=pool)
        assert b.configure({"sink": self.SPEC})["src"].tensors[0].shape == (3, 2, 3)
        return b

    def test_host_rows_land_in_a_lease_and_it_is_reused(self):
        pool = tpool.BufferPool(max_per_class=2)
        b = self._batch(pool)
        rows = [torch.full((2, 3), i, dtype=torch.uint8) for i in range(3)]
        out = b.process(None, Frame(tensors=tuple(rows))).tensors[0]
        assert out.pool_fresh and out._pool_lease[0] is pool
        np.testing.assert_array_equal(out.numpy(), np.stack([r.numpy() for r in rows]))
        ptr = out.data_ptr()
        del out
        gc.collect()
        assert pool.stats()["recycles"] == 1
        again = b.process(None, Frame(tensors=tuple(rows))).tensors[0]
        assert not again.pool_fresh and again.data_ptr() == ptr
        assert pool.stats()["hits"] == 1

    def test_mismatched_rows_refused(self):
        spec = TensorsSpec(tensors=(TensorSpec(np.uint8, (2, 3)), TensorSpec(np.uint8, (3, 2))))
        with pytest.raises(tnns.NegotiationError):
            TensorBatch().configure({"sink": spec})


class TestUnbatch:
    def _unbatch(self, to_host):
        u = TensorUnbatch()
        u.configure({"sink": TensorsSpec.of(TensorSpec(np.float32, (3, 4)))})
        u._to_host = to_host
        return u

    @pytest.mark.parametrize("to_host", [True, False])
    def test_rows_are_views_of_the_batch(self, to_host):
        x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        out = self._unbatch(to_host).process(None, Frame(tensors=(x,))).tensors
        assert len(out) == 3 and all(o.data_ptr() == x[i].data_ptr() for i, o in enumerate(out))

    def test_residency_walk_decides_host_or_device(self):
        """A filter on the card within plumbing downstream: rows stay on the
        device; a sink: one copy to the host.  The walk crosses tee, demux
        and queue, as the reference's does."""
        class CardBackend:
            device = torch.device("cuda")

        p = tnns.parse_launch("datasrc name=s ! tensor_unbatch name=u ! queue ! "
                              "tensor_filter framework=torch name=f ! tensor_sink")
        from nnstreamer_tpu_torch.graph.residency import chain_device_resident

        p["f"].backend = CardBackend()
        assert chain_device_resident(p["u"], "down")
        p["f"].backend = TorchBackend()
        p["f"].backend.device = torch.device("cpu")
        assert not chain_device_resident(p["u"], "down")
        q = tnns.parse_launch("datasrc ! tensor_unbatch name=u ! tensor_demux name=d "
                              "d.src_0 ! tensor_sink d.src_1 ! tensor_sink")
        assert not chain_device_resident(q["u"], "down")


class TestInt8HeadUnderBatching:
    """The int8 head quantizes the whole batch with one per-tensor scale
    (``quantize_activations(y)``, ``nnstreamer_tpu/models/mobilenet_v2.py``),
    so a frame's logits depend on the other frames of its batch.  The port
    copies this: on the same float32 features its int8 activations and
    scale equal the reference's exactly (so do the int32 accumulators), and
    an outlier frame moves the other rows' logits in both alike."""

    @pytest.fixture(scope="class")
    def heads(self, tree):
        jmodel = jm.build_quantized(**KW, batch=N, params=tree, int8_head=True)
        tmodel = tm.build_quantized(**KW, batch=N, params=tree, int8_head=True, device="cpu")
        jhead = jmodel.params["classifier"]

        @jax.jit
        def jax_head(f):
            q, s = jq.quantize_activations(f)
            return q, s, jk.int8_matmul(q, jhead["w"].q, s, jhead["w"].scale.reshape(1, -1),
                                        jhead["b"])

        return jax_head, tmodel.params["classifier"], jhead

    def _both(self, heads, feats):
        jax_head, thead, jhead = heads
        jq8, js, want = (np.asarray(a) for a in jax_head(feats))
        q, s = quantize_activations(torch.from_numpy(feats))
        np.testing.assert_array_equal(q.numpy(), jq8)
        assert s.numpy() == js
        got = tm.int8_head(thead, torch.from_numpy(feats)).numpy()
        acc = jq8.astype(np.int64) @ np.asarray(jhead["w"].q).astype(np.int64)
        prod = acc.astype(np.float32) * (js * np.asarray(jhead["w"].scale).reshape(1, -1))
        # the epilogue bound of test_torch_mobilenet: XLA fuses acc*s + b
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(prod)) + np.spacing(np.abs(got)))
        return got, want, js

    def test_outlier_frame_moves_the_other_rows_alike(self, heads):
        feats = (np.random.default_rng(3).standard_normal((N, 1280)) * 2).astype(np.float32)
        base_got, base_want, base_scale = self._both(heads, feats)
        feats[0] *= 40.0  # one outlier frame in the batch
        got, want, scale = self._both(heads, feats)
        assert scale > base_scale
        moved_port = got[1:] - base_got[1:]
        moved_ref = want[1:] - base_want[1:]
        assert np.abs(moved_ref).max() > 0  # the other frames' logits moved
        np.testing.assert_allclose(moved_port, moved_ref, rtol=0,
                                   atol=4 * np.spacing(np.abs(want[1:]).max()))

    def test_int8_head_graph_matches_the_reference(self, tree):
        """Config 5's int8-head variant (float32 trunk) through both
        packages.  Features within ~1e-5 of each other can quantize one
        int8 step apart, each such step moving a logit by one activation
        step times a weight (about 4e-3 here on logits of about 6): held
        to 1e-2 of the largest logit, with the top-1 labels equal."""
        frames = _frames(2)
        jmodel = jm.build_quantized(**KW, batch=N, dtype=jnp.float32, params=tree,
                                    int8_head=True)
        tmodel = tm.build_quantized(**KW, batch=N, dtype=torch.float32, params=tree,
                                    int8_head=True, device="cpu")
        _, got = _run(True, tmodel, frames)
        _, want = _run(False, jmodel, frames)
        top = max(np.abs(w).max() for i in want for _, w in want[i])
        _check(got, want, atol=1e-2 * top)
        for i in want:
            for (_, g), (_, w) in zip(got[i], want[i]):
                assert int(np.argmax(g)) == int(np.argmax(w))

"""The port's sequence parallelism against the JAX package's.

Case for case with the JAX package's ``tests/test_sequence_parallel.py``:
ring attention and Ulysses attention, causal and not, in float32 and
bfloat16, on the port's 8-shard CPU mesh (``force_device_count``'s list of
eight CPU devices) against the JAX functions under ``shard_map`` on its 8
virtual CPU devices, with the same numpy-seeded inputs; the indivisible
heads error; the transformer's three attention modes; ViT with ring
attention in a small pipeline; the aggregator's windows into a ring
filter.

Tolerances.  Ring attention accumulates in float32 in both packages: port
against JAX within 2e-6 of the largest output in float32 (sums in another
order) and within one bfloat16 step (2^-7) of it in bfloat16, where both
round the same float32 result.  Ulysses runs the golden path, which rounds
the softmax in the compute dtype: float32 within 2e-6, bfloat16 within
2^-6 (XLA keeps intermediate bfloat16 results in float32 where the port
rounds each step).  Against the port's own full attention: 2e-5 absolute
in float32, the reference test's; in bfloat16 ring and full differ by more
than rounding in either package (float32 accumulators against a rounded
softmax): 2^-5 of the largest output.  The encoders: float32 within 5e-4,
the reference test's tolerance between modes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.models import vit as jv
from nnstreamer_tpu.parallel import ring_attention as jring
from nnstreamer_tpu.parallel import sequence_sharding as jsequence_sharding
from nnstreamer_tpu.parallel import ulysses_attention as julysses
from nnstreamer_tpu_torch.models import transformer as tt
from nnstreamer_tpu_torch.models import vit as tv
from nnstreamer_tpu_torch.parallel import (
    full_attention,
    make_mesh,
    ring_attention,
    sequence_sharding,
    ulysses_attention,
)
from nnstreamer_tpu_torch.parallel.mesh import Sharded

CPU8 = [torch.device("cpu")] * 8
DIMS = dict(d_model=32, n_heads=4, n_layers=2)


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    return make_mesh((8,), ("sp",), CPU8), Mesh(np.array(devs[:8]), ("sp",))


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    b, t, h, d = 2, 64, 8, 16
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))


def _port(arrays, dtype):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _jax(arrays, dtype, jmesh):
    sh = jsequence_sharding(jmesh)
    return tuple(jax.device_put(jnp.asarray(a, dtype), sh) for a in arrays)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"max error {err} > {rel} x {top}"


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
    def test_matches_the_reference(self, meshes, qkv, causal, dtypes):
        pmesh, jmesh = meshes
        tdt, jdt = dtypes
        got = ring_attention(*_port(qkv, tdt), pmesh, causal=causal)
        want = jring(*_jax(qkv, jdt, jmesh), jmesh, causal=causal)
        assert got.dtype == tdt
        _close(got.float().numpy(), np.asarray(want, np.float32),
               2e-6 if tdt == torch.float32 else 2.0 ** -7)

    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_full(self, meshes, qkv, causal):
        pmesh, _ = meshes
        q, k, v = _port(qkv, torch.float32)
        got = ring_attention(q, k, v, pmesh, causal=causal)
        np.testing.assert_allclose(got.numpy(), full_attention(q, k, v, causal=causal).numpy(),
                                   atol=2e-5)

    def test_bfloat16_ring_against_full(self, meshes, qkv):
        pmesh, _ = meshes
        q, k, v = _port(qkv, torch.bfloat16)
        _close(ring_attention(q, k, v, pmesh).float().numpy(),
               full_attention(q, k, v).float().numpy(), 2.0 ** -5)

    def test_output_stays_sequence_sharded(self, meshes, qkv):
        pmesh, _ = meshes
        sh = sequence_sharding(pmesh)
        q, k, v = (sh.place(a) for a in _port(qkv, torch.float32))
        out = ring_attention(q, k, v, pmesh)
        assert isinstance(out, Sharded) and out.sharding.spec[1] == "sp"
        assert len(out.shards) == 8 and out.shards[0].shape == (2, 8, 8, 16)
        whole = ring_attention(*_port(qkv, torch.float32), pmesh)
        assert torch.equal(out.gather(), whole)

    def test_a_fully_masked_block_gives_no_nan(self, meshes):
        """Causal rows of shard 0 see every later shard's block fully
        masked: the guards keep the accumulators finite."""
        pmesh, _ = meshes
        x = torch.randn(1, 16, 2, 4)
        out = ring_attention(x, x, x, pmesh, causal=True)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), full_attention(x, x, x, causal=True).numpy(),
                                   atol=2e-5)


class TestUlysses:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
    def test_matches_the_reference(self, meshes, qkv, causal, dtypes):
        pmesh, jmesh = meshes
        tdt, jdt = dtypes
        got = ulysses_attention(*_port(qkv, tdt), pmesh, causal=causal)
        want = julysses(*_jax(qkv, jdt, jmesh), jmesh, causal=causal)
        _close(got.float().numpy(), np.asarray(want, np.float32),
               2e-6 if tdt == torch.float32 else 2.0 ** -6)

    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_full(self, meshes, qkv, causal):
        pmesh, _ = meshes
        q, k, v = _port(qkv, torch.float32)
        np.testing.assert_allclose(ulysses_attention(q, k, v, pmesh, causal=causal).numpy(),
                                   full_attention(q, k, v, causal=causal).numpy(), atol=2e-5)

    def test_rejects_indivisible_heads(self, meshes):
        pmesh, jmesh = meshes
        q = torch.zeros((1, 16, 6, 8))  # 6 heads on 8 devices
        with pytest.raises(ValueError, match="divisible"):
            ulysses_attention(q, q, q, pmesh)
        with pytest.raises(ValueError, match="divisible"):
            julysses(jnp.zeros((1, 16, 6, 8)), jnp.zeros((1, 16, 6, 8)),
                     jnp.zeros((1, 16, 6, 8)), jmesh)


def _tree(seed=0, d_in=32, n_out=16, **over):
    d = {**DIMS, **over}
    return jt.init_params(jax.random.PRNGKey(seed), d["d_model"], d["n_heads"], d["n_layers"],
                          4 * d["d_model"], d_in, n_out)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class TestTransformerModel:
    def test_modes_agree(self, meshes):
        """The three modes of the port's encoder, on the reference's tree,
        against the reference's full and ring encoders."""
        pmesh, jmesh = meshes
        tree = _tree()
        x = np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32)
        want, want_ring = (np.asarray(a) for a in jax.jit(lambda a: (
            jt.apply(tree, a, attn="full"), jt.apply(tree, a, attn="ring", mesh=jmesh)))(x))
        # 4 heads: Ulysses over 4 of the 8 devices
        mesh_of = {"full": None, "ring": pmesh, "ulysses": make_mesh((4,), ("sp",), CPU8[:4])}
        for mode in ("full", "ring", "ulysses"):
            m = tt.build(seq_len=64, d_in=32, attn=mode, mesh=mesh_of[mode],
                         params=_np(tree), device="cpu", **DIMS)
            out = m(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(out, want, atol=5e-4, err_msg=mode)
            if mode == "ring":
                _close(out, want_ring, 2e-5)

    def test_streaming_pipeline_with_ring_attention(self, meshes):
        """Aggregated sensor windows into a sequence-parallel filter: 128
        single-step frames, windows of 64, both packages' outputs equal
        within 2e-5 of the largest."""
        pmesh, jmesh = meshes
        tree = _tree(2, d_in=32, n_out=8)
        frames = [np.random.default_rng(i).standard_normal((1, 32)).astype(np.float32)
                  for i in range(128)]
        desc = ("datasrc name=s ! tensor_aggregator frames-in=1 frames-out=64 frames-dim=1 ! "
                "tensor_filter framework={fw} name=f ! tensor_sink name=out")
        outs = {}
        for name, nns, fw, model, data in (
                ("port", tnns, "torch",
                 tt.build(seq_len=64, d_in=32, n_out=8, attn="ring", mesh=pmesh,
                          params=_np(tree), device="cpu", **DIMS),
                 [torch.from_numpy(f) for f in frames]),
                ("jax", jnns, "jax",
                 jt.build(seq_len=64, d_in=32, n_out=8, attn="ring", mesh=jmesh, params=tree,
                          **DIMS), frames)):
            got = []
            p = nns.parse_launch(desc.replace("{fw}", fw))
            p["s"].data = data
            p["f"].model = model
            p["out"].connect("new-data", lambda f, got=got: got.append(np.asarray(f.tensors[0])))
            p.run(timeout=120)
            outs[name] = got
        assert len(outs["port"]) == len(outs["jax"]) == 2
        for a, b in zip(outs["port"], outs["jax"]):
            assert a.shape == b.shape == (64, 8)
            _close(a, b, 2e-5)


class TestVitRing:
    def test_vit_ring_in_a_pipeline(self, meshes):
        """A small ViT (32x32 images, 8x8 patches: 16 tokens, 2 a shard)
        with ring attention through a launch string, against the
        reference's ViT with ring attention on its mesh, float32: within
        2e-5 of the largest logit, top-1 equal."""
        pmesh, jmesh = meshes
        cfg = dict(num_classes=10, image_size=32, patch=8, d_model=32, n_heads=4, n_layers=2)
        ref = jv.build(**cfg, attn="ring", mesh=jmesh, dtype=jnp.float32)
        model = tv.build(**cfg, attn="ring", mesh=pmesh, dtype="float32",
                         params=_np(ref.params), device="cpu")
        frames = [np.random.default_rng(10 + i).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
                  for i in range(3)]
        got = []
        p = tnns.parse_launch("datasrc name=s ! tensor_upload ! queue ! "
                              "tensor_filter framework=torch name=f ! tensor_sink name=out")
        p["s"].data = [torch.from_numpy(f) for f in frames]
        p["f"].model = model
        p["out"].connect("new-data", lambda f: got.append(f.tensors[0].numpy()))
        p.run(timeout=120)
        assert len(got) == 3
        wants = np.asarray(jax.jit(lambda a: ref.apply(ref.params, a))(np.stack(frames)))
        for a, want in zip(got, wants):
            _close(a, want, 2e-5)
            assert int(a.argmax()) == int(want.argmax())
        ulysses = tv.build(**cfg, attn="ulysses", mesh=make_mesh((4,), ("sp",), CPU8[:4]),
                           dtype="float32", params=_np(ref.params), device="cpu")
        _close(ulysses(torch.from_numpy(frames[0])).numpy(), got[0], 2e-5)

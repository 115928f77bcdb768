"""The port's expert parallelism (switch MoE) and pipeline parallelism
(GPipe) against the JAX package's.

Case for case with the JAX package's ``tests/test_moe_pipeline.py``, on
the port's CPU meshes (lists of CPU devices) against the JAX functions on
its virtual CPU devices, with the reference's trees (numpy leaves of its
``init_moe_params`` / ``init_params``) and numpy-seeded inputs: top-1
routing token by token, the routing itself (expert indices, slots, drop
masks and capacity) exactly the reference's formulas, expert parallelism
against the reference's ``ep`` mesh, capacity overflow, bfloat16 routing
above 256 tokens an expert, the MoE encoder in a filter, GPipe with linear
stages and its microbatch counts, an indivisible batch, and
``build_pipelined`` on the reference's stage-stacked tree.

Tolerances: float32 outputs within 2e-5 (the reference test's, which
holds its sharded against its unsharded runs), 3e-5 for the pipelined
encoder; bfloat16 routing within 0.1, the reference test's.
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
from nnstreamer_tpu.parallel import moe as jmoe
from nnstreamer_tpu.parallel import pipeline_par as jpp
from nnstreamer_tpu_torch.models import transformer as tt
from nnstreamer_tpu_torch.parallel import make_mesh
from nnstreamer_tpu_torch.parallel import moe as tmoe
from nnstreamer_tpu_torch.parallel import pipeline_par as tpp
from nnstreamer_tpu_torch.parallel.mesh import Sharded

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def ep_meshes(n=8):
    return make_mesh((n,), ("ep",), [CPU] * n), Mesh(np.array(jax.devices()[:n]), ("ep",))


def pp_meshes(n=4):
    return make_mesh((n,), ("pp",), [CPU] * n), Mesh(np.array(jax.devices()[:n]), ("pp",))


def _ref_route(params, x, capacity_factor):
    """The reference's routing lines (``nnstreamer_tpu/parallel/moe.py``),
    in jnp: expert, slot, keep, capacity."""
    t = x.shape[0]
    e = params["w1"].shape[0]
    cap = max(1, int(np.ceil(t * capacity_factor / e)))
    probs = jax.nn.softmax(x @ params["gate"]["w"] + params["gate"]["b"], axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return np.asarray(expert), np.asarray(pos), np.asarray(pos < cap), cap


class TestMoE:
    def test_top1_routing_matches_manual(self):
        """Ample capacity: each token through its argmax expert, scaled by
        the gate probability, token by token."""
        d, ff, e, t = 8, 16, 4, 12
        params = jmoe.init_moe_params(jax.random.PRNGKey(0), d, ff, e)
        x = np.array(jax.random.normal(jax.random.PRNGKey(1), (t, d), jnp.float32))
        out = tmoe.moe_ffn(_t(params), torch.from_numpy(x), capacity_factor=4.0).numpy()
        p = _np(params)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ p["gate"]["w"] + p["gate"]["b"])))
        for i in range(t):
            k = int(np.argmax(probs[i]))
            h = np.asarray(jax.nn.gelu(x[i] @ p["w1"][k] + p["b1"][k]))
            want = (h @ p["w2"][k] + p["b2"][k]) * probs[i, k]
            np.testing.assert_allclose(out[i], want, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 2.0])
    def test_routing_equals_the_reference_exactly(self, capacity_factor):
        d, ff, e, t = 16, 32, 8, 64
        params = jmoe.init_moe_params(jax.random.PRNGKey(2), d, ff, e)
        x = np.random.default_rng(3).standard_normal((t, d)).astype(np.float32)
        expert, pos, keep, cap = _ref_route(params, jnp.asarray(x), capacity_factor)
        r = tmoe.route(_t(params), torch.from_numpy(x), capacity_factor)
        assert r["cap"] == cap
        np.testing.assert_array_equal(r["expert"].numpy(), expert)
        np.testing.assert_array_equal(r["pos"].numpy(), pos)
        np.testing.assert_array_equal(r["keep"].numpy(), keep)
        assert r["pos"].dtype == torch.int32

    def test_expert_parallel_matches_the_reference_mesh(self):
        """8 experts over the port's 8-device ``ep`` mesh (weights placed
        once) against the reference's ``ep`` mesh run, and against the
        unsharded port."""
        d, ff, e, t = 16, 32, 8, 64
        params = jmoe.init_moe_params(jax.random.PRNGKey(2), d, ff, e)
        x = np.array(jax.random.normal(jax.random.PRNGKey(3), (t, d), jnp.float32))
        pmesh, jmesh = ep_meshes(8)
        placed = jmoe.place_moe_params(params, jmesh, "ep")
        want = np.asarray(jax.jit(lambda p, a: jmoe.moe_ffn(p, a, mesh=jmesh, axis="ep"))(
            placed, x))
        port = tmoe.place_moe_params(_t(params), pmesh, "ep")
        assert isinstance(port["w1"], Sharded) and len(port["w1"].shards) == 8
        got = tmoe.moe_ffn(port, torch.from_numpy(x), mesh=pmesh, axis="ep").numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        whole = tmoe.moe_ffn(_t(params), torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, whole)  # the split is a re-layout only

    def test_capacity_overflow_drops_to_zero(self):
        """Tokens past an expert's capacity come back as zeros: every token
        forced to expert 0, capacity 2."""
        d, ff, e, t = 4, 8, 2, 10
        params = _np(jmoe.init_moe_params(jax.random.PRNGKey(4), d, ff, e))
        params["gate"]["b"] = np.asarray([100.0, -100.0], np.float32)
        x = np.array(jax.random.normal(jax.random.PRNGKey(5), (t, d), jnp.float32))
        out = tmoe.moe_ffn(_t(params), torch.from_numpy(x), capacity_factor=0.4).numpy()
        want = np.asarray(jmoe.moe_ffn(params, jnp.asarray(x), capacity_factor=0.4))
        nonzero = np.abs(out).sum(axis=-1) > 1e-9
        assert nonzero.sum() == 2 and nonzero[:2].all()
        np.testing.assert_array_equal(nonzero, np.abs(want).sum(axis=-1) > 1e-9)
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)

    def test_bf16_routing_survives_large_expert_load(self):
        """600 tokens on one expert in bfloat16: the slots stay exact past
        256 (int32 bookkeeping), no token lost to a slot collision."""
        d, ff, e, t = 4, 8, 2, 600
        params = _np(jmoe.init_moe_params(jax.random.PRNGKey(6), d, ff, e))
        params["gate"]["b"] = np.asarray([100.0, -100.0], np.float32)
        x = np.array(jax.random.normal(jax.random.PRNGKey(7), (t, d), jnp.float32))
        out = tmoe.moe_ffn(_t(params), torch.from_numpy(x), capacity_factor=2.0,
                           dtype=torch.bfloat16).float().numpy()
        h = np.asarray(jax.nn.gelu(x @ params["w1"][0] + params["b1"][0]))
        want = h @ params["w2"][0] + params["b2"][0]
        np.testing.assert_allclose(out, want, rtol=0.1, atol=0.1)
        assert (np.abs(out[256:]).sum(axis=-1) > 1e-3).all()
        r = tmoe.route(_t(params), torch.from_numpy(x).to(torch.bfloat16), 2.0, torch.bfloat16)
        np.testing.assert_array_equal(r["pos"].numpy(), np.arange(t))

    def test_moe_transformer_runs_in_filter(self):
        """The MoE encoder streams through ``tensor_filter`` in both
        packages on one tree, experts over a 4-device ``ep`` mesh in the
        port: equal within 2e-5 of the largest output."""
        tree = jt.init_params(jax.random.PRNGKey(3), 16, 2, 1, 64, 4, 3, moe_experts=4)
        kw = dict(seq_len=8, d_in=4, n_out=3, d_model=16, n_heads=2, n_layers=1,
                  moe_experts=4)
        pmesh, _ = ep_meshes(4)
        frames = [np.random.default_rng(i).standard_normal((8, 4)).astype(np.float32)
                  for i in range(3)]
        outs = {}
        for name, nns, fw, model, data in (
                ("port", tnns, "torch",
                 tt.build(**kw, params=_np(tree), moe_mesh=pmesh, moe_axis="ep",
                          device="cpu"), [torch.from_numpy(f) for f in frames]),
                ("jax", jnns, "jax", jt.build(**kw, params=tree), frames)):
            got = []
            p = nns.parse_launch(f"datasrc name=s ! tensor_filter framework={fw} name=f ! "
                                 "tensor_sink name=out")
            p["s"].data = data
            p["f"].model = model
            p["out"].connect("new-data", lambda f, got=got: got.append(np.asarray(f.tensors[0])))
            p.run(timeout=120)
            outs[name] = got
        assert len(outs["port"]) == 3 and outs["port"][0].shape == (8, 3)
        for a, b in zip(outs["port"], outs["jax"]):
            np.testing.assert_allclose(a, b, atol=2e-5 * float(np.abs(b).max()))

    def test_moe_refusals_keep_the_reference_words(self):
        tree = _np(jt.init_params(jax.random.PRNGKey(8), 16, 2, 1, 32, 6, 5, moe_experts=2))
        params = tt.prepare(tree, device="cpu")
        with pytest.raises(NotImplementedError, match="capacity semantics are sequence-level"):
            tt.decode_step(params, torch.ones(6), tt.init_decode_cache(1, 16, 2, device="cpu"),
                           torch.zeros(1, dtype=torch.int32))
        with pytest.raises(NotImplementedError, match="FULL batch"):
            tt.prefill(params, torch.zeros(4, 6), 8)
        with pytest.raises(NotImplementedError, match="expert-level scale"):
            tt.build_quantized(moe_experts=2, device="cpu")
        with tmoe.record_routes() as routes:
            tt.apply(params, torch.zeros(4, 6))
        assert len(routes) == 1 and routes[0]["cap"] == 4  # ceil(4 x 2.0 / 2)


class TestGPipe:
    def test_linear_stages_match_sequential_and_the_reference(self):
        """4 pipelined linear stages: the sequential chain and the
        reference's GPipe on its 4-device ``pp`` mesh."""
        rng = np.random.default_rng(0)
        d, b = 8, 8
        ws = [rng.standard_normal((d, d)).astype(np.float32) * 0.3 for _ in range(4)]
        x = rng.standard_normal((b, d)).astype(np.float32)
        pmesh, jmesh = pp_meshes(4)
        got = tpp.gpipe_apply(lambda p, a: torch.tanh(a @ p["w"]),
                              tpp.stack_stage_params([{"w": torch.from_numpy(w)} for w in ws]),
                              torch.from_numpy(x), pmesh, "pp").numpy()
        want = np.asarray(jpp.gpipe_apply(
            lambda p, a: jnp.tanh(a @ p["w"]),
            jpp.stack_stage_params([{"w": jnp.asarray(w)} for w in ws]), jnp.asarray(x),
            jmesh, "pp"))
        ref = x
        for w in ws:
            ref = np.tanh(ref @ w)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_microbatch_count_variants(self):
        rng = np.random.default_rng(1)
        d = 4
        ws = [rng.standard_normal((d, d)).astype(np.float32) * 0.3 for _ in range(2)]
        stages = tpp.stack_stage_params([{"w": torch.from_numpy(w)} for w in ws])
        pmesh = make_mesh((2,), ("pp",), [CPU] * 2)
        x = rng.standard_normal((12, d)).astype(np.float32)
        ref = x @ ws[0] @ ws[1]
        for m in (2, 3, 6, 12):
            out = tpp.gpipe_apply(lambda p, a: a @ p["w"], stages, torch.from_numpy(x), pmesh,
                                  "pp", microbatches=m)
            np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)

    def test_indivisible_batch_rejected(self):
        pmesh = make_mesh((2,), ("pp",), [CPU] * 2)
        stages = tpp.stack_stage_params([{"w": torch.eye(4)} for _ in range(2)])
        with pytest.raises(ValueError, match="divisible"):
            tpp.gpipe_apply(lambda p, a: a, stages, torch.ones(7, 4), pmesh, "pp",
                            microbatches=2)

    def test_pipelined_transformer_matches_the_reference(self):
        """``build_pipelined`` on the reference's own ``(outer,
        stage_stacked)`` tree: the reference's pipelined model and the
        sequential encoder on the same weights."""
        pmesh, jmesh = pp_meshes(4)
        kw = dict(seq_len=6, d_in=4, n_out=3, d_model=8, n_heads=2, n_layers=4, seed=7)
        jmodel = jt.build_pipelined(jmesh, "pp", batch=8, **kw)
        x = np.random.default_rng(9).standard_normal((8, 6, 4)).astype(np.float32)
        want = np.asarray(jax.jit(jmodel.apply)(jmodel.params, x))
        model = tt.build_pipelined(pmesh, "pp", batch=8, params=_np(jmodel.params),
                                   device="cpu", **kw)
        got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
        seq = jt.init_params(jax.random.PRNGKey(7), 8, 2, 4, 32, 4, 3)
        np.testing.assert_allclose(got, np.asarray(jt.apply(seq, x)), rtol=3e-5, atol=3e-5)
        # the port's own tree, stacked here, against its sequential encoder
        tree = tt.init_tree(5, 8, 2, 4, 32, 4, 3)
        own = tt.build_pipelined(pmesh, "pp", batch=8, params=tree, device="cpu", **kw)
        np.testing.assert_allclose(own(torch.from_numpy(x)).numpy(),
                                   tt.apply(tt.prepare(tree, device="cpu"),
                                            torch.from_numpy(x)).numpy(), rtol=3e-5, atol=3e-5)
        assert len(model.params[1]) == 4  # a tree a stage

    def test_pipelined_layers_must_divide_into_stages(self):
        pmesh, _ = pp_meshes(4)
        with pytest.raises(ValueError, match="not divisible by 4 stages"):
            tt.build_pipelined(pmesh, "pp", n_layers=6, device="cpu")


def test_parallel_inference_example_runs_the_three_modes():
    """``nnstreamer_tpu_torch/examples/parallel_inference.py`` on 8 CPU
    shards: the ep, pp and sp legs through ``tensor_filter``, their
    outputs finite and of the model's shapes; the forced device list is
    given back."""
    from nnstreamer_tpu_torch.examples import parallel_inference
    from nnstreamer_tpu_torch.parallel import mesh as pmesh

    out = parallel_inference.main(device="cpu", shards=8)
    assert [len(out[k]) for k in ("ep", "pp", "sp")] == [4, 3, 2]
    assert out["ep"][0].shape == (16, 4) and out["pp"][0].shape == (16, 8, 4)
    assert out["sp"][0].shape == (64, 4)
    assert all(np.isfinite(a).all() for leg in out.values() for a in leg)
    assert pmesh.visible_devices() == [CPU]

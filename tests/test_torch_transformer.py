"""The port's transformer encoder and decode cell against the JAX package's.

``models/transformer.py``: the encoder (:func:`apply`, causal and not),
the decode step in both capacity disciplines (the NaN past ``t_max``, the
ring past it), prefill with length buckets, the decode cell as a stream
filter, stepwise against the full pass, W8A8, and
``parallel/ring_attention.py::full_attention``.  Every case runs the JAX
function on the CPU on the same params (``params_from_jax`` of its tree)
and the same inputs, made from numpy seeds.  Small size: d_model 32, 4
heads, 2 layers, t_max 16.

Tolerances: float32 outputs within 1e-5 of the largest reference
magnitude (the two sides sum their products in other orders); W8A8's int8
activations and int32 accumulators equal on the same float32 input, the
W8A8 outputs within 1e-4 (decode) and 1/32 (the encoder, where an int8
activation flips: see its test) of the largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.ops import quant as jq
from nnstreamer_tpu.parallel.ring_attention import full_attention as jfull_attention
from nnstreamer_tpu_torch.models import transformer as tt
from nnstreamer_tpu_torch.ops import quant as tq
from nnstreamer_tpu_torch.parallel import full_attention

DIMS = dict(d_model=32, n_heads=4, n_layers=2, d_in=8, n_out=4)
T_MAX = 16
REL = 1e-5


def _tree(seed=0, **over):
    d = {**DIMS, **over}
    return jt.init_params(jax.random.PRNGKey(seed), d["d_model"], d["n_heads"], d["n_layers"],
                          4 * d["d_model"], d["d_in"], d["n_out"])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree, dtype=torch.float32):
    return tt.prepare(_np(tree), dtype, "cpu")


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max error {err} > {rel} x {scale}"


def _steps(seed, n, d_in=DIMS["d_in"]):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(d_in).astype(np.float32) for _ in range(n)]


class TestAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_full_attention_matches_reference(self, causal):
        rng = np.random.default_rng(1)
        q, k, v = (rng.standard_normal((2, 7, 4, 8)).astype(np.float32) for _ in range(3))
        want = np.asarray(jfull_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          causal=causal))
        got = full_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
        _close(got.numpy(), want)

    def test_mesh_modes_point_at_item_13(self):
        """ROADMAP item 13's modes run (the refusals this test held are
        lifted): ring and Ulysses attention over a 4-device CPU mesh equal
        the full encoder within 1e-5 of the largest output, an MoE build and
        a pipelined build run; a mesh mode without a mesh and an unknown
        mode still raise.  Parity with the JAX package is in
        ``tests/test_torch_sequence_parallel.py`` and
        ``tests/test_torch_moe_pipeline.py``."""
        from nnstreamer_tpu_torch.parallel.mesh import make_mesh

        p = _port(_tree())
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (8, DIMS["d_in"])).astype(np.float32))
        mesh = make_mesh((4,), ("sp",), [torch.device("cpu")] * 4)
        full = tt.apply(p, x)
        for mode in ("ring", "ulysses"):
            _close(tt.apply(p, x, attn=mode, mesh=mesh), full)
            with pytest.raises(ValueError, match="mesh"):
                tt.apply(p, x, attn=mode)
        moe = tt.build(seq_len=8, d_in=4, n_out=3, d_model=16, n_heads=2, n_layers=1,
                       moe_experts=4, device="cpu")
        assert moe(torch.zeros(8, 4)).shape == (8, 3)
        pp = tt.build_pipelined(make_mesh((2,), ("pp",), [torch.device("cpu")] * 2), "pp",
                                seq_len=4, d_in=4, n_out=3, d_model=16, n_heads=2, n_layers=2,
                                batch=2, device="cpu")
        assert pp(torch.zeros(2, 4, 4)).shape == (2, 4, 3)
        with pytest.raises(ValueError, match="unknown attention"):
            tt.apply(p, x, attn="sparse")


class TestEncoder:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("batched", [True, False])
    def test_apply_matches_reference(self, causal, batched):
        tree = _tree(2)
        shape = (3, 10, DIMS["d_in"]) if batched else (10, DIMS["d_in"])
        x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
        want = np.asarray(jax.jit(lambda v: jt.apply(tree, v, causal=causal))(x))
        got = tt.apply(_port(tree), torch.from_numpy(x), causal=causal)
        assert got.dtype == torch.float32
        _close(got.numpy(), want)

    def test_pos_embed_is_added(self):
        tree = _tree(4)
        tree["pos_embed"] = jnp.asarray(np.random.default_rng(5).standard_normal(
            (6, DIMS["d_model"])).astype(np.float32))
        x = np.random.default_rng(6).standard_normal((6, DIMS["d_in"])).astype(np.float32)
        want = np.asarray(jt.apply(tree, jnp.asarray(x), causal=False))
        _close(tt.apply(_port(tree), torch.from_numpy(x), causal=False).numpy(), want)

    def test_build_serves_the_reference_tree(self):
        tree = _tree(7)
        jm = jt.build(seq_len=12, params=tree, **DIMS)
        tm = tt.build(seq_len=12, params=_np(tree), device="cpu", **DIMS)
        x = np.random.default_rng(8).standard_normal((12, DIMS["d_in"])).astype(np.float32)
        want = np.asarray(jax.jit(jm.fn())(x))
        _close(tm(torch.from_numpy(x)).numpy(), want)
        assert tuple(tm.input_spec.tensors[0].shape) == (12, DIMS["d_in"])
        assert tuple(tm.output_spec.tensors[0].shape) == (12, DIMS["n_out"])

    def test_builders_default_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for build in (tt.build, tt.build_quantized, tt.build_decode_cell):
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                build(**DIMS)

    def test_weights_are_cast_once_at_build(self):
        """bfloat16 params hold the reference's cast-at-use bits."""
        tree = _tree(9)
        p = tt.prepare(_np(tree), "bfloat16", "cpu")
        w = np.asarray(tree["blocks"][0]["qkv"]["w"].astype(jnp.bfloat16).astype(jnp.float32))
        assert p["blocks"][0]["qkv"]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(p["blocks"][0]["qkv"]["w"].float().numpy(), w)
        assert p["n_heads"] == DIMS["n_heads"]


class TestDecode:
    @pytest.mark.parametrize("window", [False, True])
    def test_decode_steps_match_reference(self, window):
        """Both capacity disciplines, past t_max: the plain cache saturates
        to NaN (and its pos keeps counting), the ring stays finite and
        wraps pos into [0, 2 T_max)."""
        tree = _tree(10)
        p = _port(tree)
        cj = jt.init_decode_cache(DIMS["n_layers"], DIMS["d_model"], T_MAX)
        pj = jnp.zeros((1,), jnp.int32)
        ct = tt.init_decode_cache(DIMS["n_layers"], DIMS["d_model"], T_MAX, device="cpu")
        pt = torch.zeros(1, dtype=torch.int32)
        step = jax.jit(lambda x, c, q: jt.decode_step(tree, x, c, q, window=window))
        n = 2 * T_MAX + 5
        for i, x in enumerate(_steps(11, n)):
            yj, cj, pj = step(jnp.asarray(x), cj, pj)
            before = ct.clone()
            yt, ct2, pt = tt.decode_step(p, torch.from_numpy(x), ct, pt, window=window)
            assert torch.equal(ct, before), "decode_step wrote into its input"
            ct = ct2
            yj = np.asarray(yj)
            assert int(pt[0]) == int(pj[0])
            if not window and i >= T_MAX:
                assert np.isnan(yj).all() and torch.isnan(yt).all()
            else:
                assert np.isfinite(yj).all()
                _close(yt.numpy(), yj)
            _close(ct.numpy(), np.asarray(cj))
        if window:
            assert int(pt[0]) < 2 * T_MAX

    def test_ring_needs_pos_embed_free_params(self):
        tree = _np(_tree(12))
        tree["pos_embed"] = np.zeros((T_MAX, DIMS["d_model"]), np.float32)
        p = tt.prepare(tree, torch.float32, "cpu")
        cache = torch.zeros(DIMS["n_layers"], 2, T_MAX, DIMS["d_model"])
        with pytest.raises(ValueError, match="pos_embed-free"):
            tt.decode_step(p, torch.zeros(DIMS["d_in"]), cache,
                           torch.zeros(1, dtype=torch.int32), window=True)

    def test_step_slots_equals_decode_step_per_slot(self):
        """The batched step computes each slot's decode_step; a gated-off
        slot keeps its cache and position bit for bit."""
        p = _port(_tree(13))
        rng = np.random.default_rng(14)
        caches = torch.from_numpy(rng.standard_normal(
            (3, DIMS["n_layers"], 2, T_MAX, DIMS["d_model"])).astype(np.float32))
        pos = torch.tensor([[0], [5], [9]], dtype=torch.int32)
        xs = torch.from_numpy(rng.standard_normal((3, DIMS["d_in"])).astype(np.float32))
        gate = torch.tensor([True, False, True])
        work = caches.clone()
        ys, nxt = tt.step_slots(p, xs, work, pos, gate=gate)
        for s in (0, 2):
            y1, c1, p1 = tt.decode_step(p, xs[s], caches[s], pos[s])
            _close(ys[s].numpy(), y1.numpy())
            _close(work[s].numpy(), c1.numpy())
            assert int(nxt[s, 0]) == int(p1[0])
        assert torch.equal(work[1], caches[1]) and int(nxt[1, 0]) == 5

    def test_stepwise_equals_full_causal_pass(self):
        """Stepping the cell over a prefix gives the full causal encoder's
        outputs token by token (the reference's own invariant)."""
        tree = _tree(15)
        p = _port(tree)
        xs = _steps(16, 9)
        full = tt.apply(p, torch.from_numpy(np.stack(xs)), causal=True)
        want = np.asarray(jt.apply(tree, jnp.asarray(np.stack(xs)), causal=True))
        cache = tt.init_decode_cache(DIMS["n_layers"], DIMS["d_model"], T_MAX, device="cpu")
        pos = torch.zeros(1, dtype=torch.int32)
        for i, x in enumerate(xs):
            y, cache, pos = tt.decode_step(p, torch.from_numpy(x), cache, pos)
            _close(y.numpy(), full[i].numpy())
            _close(y.numpy(), want[i])


class TestPrefill:
    @pytest.mark.parametrize("n_valid", [1, 3, 5, 8])
    def test_bucketed_prefill_matches_reference(self, n_valid):
        """A prompt padded to the 8 bucket: y_last, the cache (padded rows
        zero) and pos equal the reference's."""
        tree = _tree(17)
        xs = np.zeros((8, DIMS["d_in"]), np.float32)
        xs[:n_valid] = np.stack(_steps(18, n_valid))
        fn = jax.jit(lambda v, n: jt.prefill(tree, v, T_MAX, n))
        yj, cj, pj = (np.asarray(a) for a in fn(jnp.asarray(xs), jnp.int32(n_valid)))
        yt, ct, pt = tt.prefill(_port(tree), torch.from_numpy(xs), T_MAX, n_valid)
        _close(yt.numpy(), yj)
        _close(ct.numpy(), cj)
        assert not ct[:, :, n_valid:].any()
        assert pt.tolist() == pj.tolist() == [n_valid]

    def test_prefill_then_decode_equals_stepping(self):
        tree = _tree(19)
        p = _port(tree)
        xs = _steps(20, 9)
        cache = tt.init_decode_cache(DIMS["n_layers"], DIMS["d_model"], T_MAX, device="cpu")
        pos = torch.zeros(1, dtype=torch.int32)
        stepped = []
        for x in xs:
            y, cache, pos = tt.decode_step(p, torch.from_numpy(x), cache, pos)
            stepped.append(y)
        padded = np.zeros((8, DIMS["d_in"]), np.float32)
        padded[:5] = np.stack(xs[:5])
        y, cache, pos = tt.prefill(p, torch.from_numpy(padded), T_MAX, torch.tensor(5))
        _close(y.numpy(), stepped[4].numpy())
        for i, x in enumerate(xs[5:]):
            y, cache, pos = tt.decode_step(p, torch.from_numpy(x), cache, pos)
            _close(y.numpy(), stepped[5 + i].numpy())

    def test_prefill_refuses_an_overlong_prompt(self):
        with pytest.raises(ValueError, match="exceeds cache t_max"):
            tt.prefill(_port(_tree()), torch.zeros(T_MAX + 1, DIMS["d_in"]), T_MAX)


class TestDecodeCell:
    def test_cell_as_a_filter_model(self):
        """build_decode_cell on the reference's tree: specs and outputs of
        a few steps against the JAX cell."""
        tree = _tree(21)
        jc = jt.build_decode_cell(t_max=T_MAX, params=tree, **DIMS)
        tc = tt.build_decode_cell(t_max=T_MAX, params=_np(tree), device="cpu", **DIMS)
        specs = [(tuple(t.shape), np.dtype(t.dtype)) for t in tc.input_spec.tensors]
        assert specs == [(tuple(t.shape), np.dtype(t.dtype)) for t in jc.input_spec.tensors]
        assert [tuple(t.shape) for t in tc.output_spec.tensors] == [
            (DIMS["n_out"],), (DIMS["n_layers"], 2, T_MAX, DIMS["d_model"]), (1,)]
        fn = jax.jit(jc.fn())
        cj = np.zeros((DIMS["n_layers"], 2, T_MAX, DIMS["d_model"]), np.float32)
        pj = np.zeros((1,), np.int32)
        ct, pt = torch.from_numpy(cj.copy()), torch.from_numpy(pj.copy())
        for x in _steps(22, 4):
            yj, cj, pj = (np.asarray(a) for a in fn(x, cj, pj))
            yt, ct, pt = tc(torch.from_numpy(x), ct, pt)
            _close(yt.numpy(), yj)
            assert pt.dtype == torch.int32 and pt.tolist() == pj.tolist()


class TestQuantized:
    def test_int32_accumulators_equal(self):
        """W8A8's product: int8 activations (per-row scales) and the int32
        accumulator bit for bit against the reference's ``dot_general``."""
        rng = np.random.default_rng(23)
        x = rng.standard_normal((5, 32)).astype(np.float32)
        w = rng.standard_normal((32, 24)).astype(np.float32)
        qw = jq.quantize_weight(w)
        qj, _ = jq.quantize_activations(jnp.asarray(x), axes=(-1,))
        accj = np.asarray(jax.lax.dot_general(qj, qw.q, (((1,), (0,)), ((), ())),
                                              preferred_element_type=jnp.int32))
        qt, _ = tq.quantize_activations(torch.from_numpy(x), axes=(-1,))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        acct = tq.int_mm(qt, tq.int8_weight_matrix(torch.from_numpy(np.array(qw.q))))[:, :24]
        np.testing.assert_array_equal(acct.numpy(), accj)

    def test_w8a8_encoder_matches_reference(self):
        """build_quantized quantizes the float32 tree as the JAX package's
        quantize_model does: the int8 leaves agree, and so do the int32
        accumulators of the first product (the embed, on the same float32
        frame).  Past it the two sides' float32 activations differ in the
        last bit (summation order), and where ``x / scale`` lies next to a
        half that flips an int8 activation by one step: here such flips move
        the output by 0.0097 of its largest value, so the outputs are held
        to 1/32 of it."""
        tree = _tree(24)
        jm = jt.build_quantized(seq_len=10, params=tree, **DIMS)
        tm = tt.build_quantized(seq_len=10, params=_np(tree), device="cpu", **DIMS)
        jw, tw = jm.params["blocks"][1]["ff1"], tm.params["blocks"][1]["ff1"]
        np.testing.assert_array_equal(tw["w"].q.numpy(), np.asarray(jw["w"].q))
        np.testing.assert_array_equal(tw["w"].scale.numpy(), np.asarray(jw["w"].scale))
        assert tw["w_mat"].dtype == torch.int8
        x = np.random.default_rng(25).standard_normal((10, DIMS["d_in"])).astype(np.float32)
        qj, _ = jq.quantize_activations(jnp.asarray(x), axes=(-1,))
        accj = np.asarray(jax.lax.dot_general(qj, jm.params["embed"]["w"].q,
                                              (((1,), (0,)), ((), ())),
                                              preferred_element_type=jnp.int32))
        qt, _ = tq.quantize_activations(torch.from_numpy(x), axes=(-1,))
        emb = tm.params["embed"]
        acct = tq.int_mm(qt, emb["w_mat"])[:, :DIMS["d_model"]]
        np.testing.assert_array_equal(acct.numpy(), accj)
        want = np.asarray(jax.jit(jm.fn())(x))
        _close(tm(torch.from_numpy(x)).numpy(), want, rel=1 / 32)

    def test_w8a8_decode_matches_reference(self):
        """The decode cell on the reference's quantized tree
        (``params_from_jax`` reads its QuantizedWeight leaves)."""
        qtree = jq.quantize_params(_tree(26))
        p = tt.prepare(_np(qtree), torch.float32, "cpu")
        assert isinstance(p["embed"]["w"], tq.QuantizedWeight)
        cj = jt.init_decode_cache(DIMS["n_layers"], DIMS["d_model"], T_MAX)
        pj = jnp.zeros((1,), jnp.int32)
        ct = tt.init_decode_cache(DIMS["n_layers"], DIMS["d_model"], T_MAX, device="cpu")
        pt = torch.zeros(1, dtype=torch.int32)
        step = jax.jit(lambda x, c, q: jt.decode_step(qtree, x, c, q))
        for x in _steps(27, 5):
            yj, cj, pj = step(jnp.asarray(x), cj, pj)
            yt, ct, pt = tt.decode_step(p, torch.from_numpy(x), ct, pt)
            _close(yt.numpy(), np.asarray(yj), rel=1e-4)

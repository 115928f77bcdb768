"""The port's two kernels against the JAX package's Pallas kernels.

Inputs are made with numpy from fixed seeds and go through
``nnstreamer_tpu.ops.pallas_kernels`` (Pallas interpret mode on the CPU, as
``tests/test_pallas_quant.py`` runs it) and through
``nnstreamer_tpu_torch.ops.kernels`` on CPU tensors, which take the plain
PyTorch versions.  The CUDA kernels themselves run only on a GPU: the tests
marked ``cuda`` hold them against the plain versions there and skip here.
``TestChainProgram`` holds ``fused_arith``'s lowered program (a numpy model
of the kernel's two variants) bitwise against the plain version and the
Pallas kernel, and ``TestFusedGeometry`` its vector and scalar accesses;
``TestInt8Geometry`` checks the split-K launch geometry and the weight loads
of ``int8_matmul``'s small-M branch, in the kernel's own index math.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings, strategies as st

import jax.numpy as jnp
import ml_dtypes

from nnstreamer_tpu.elements.transform import _bind_chain as jax_bind_chain
from nnstreamer_tpu.ops import pallas_kernels as jk
from nnstreamer_tpu_torch.elements.transform import _bind_chain, _parse_arith_ops, _parse_clamp
from nnstreamer_tpu_torch.ops import kernels as K
from nnstreamer_tpu_torch.spec import BFLOAT16

NORMALIZE = [("typecast", np.float32), ("add", -127.5), ("div", 127.5)]


def _jax_fused(x, ops):
    return np.asarray(jk.fused_arith(jnp.asarray(x), ops))


def _port_fused(x, ops):
    return K.fused_arith(torch.from_numpy(np.ascontiguousarray(x)), ops).numpy()


def _assert_bitwise(got, want):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)  # NaNs compare equal


class TestFusedArith:
    @pytest.mark.parametrize("shape", [(4,), (7, 223, 3), (256, 128), (1, 1), (33000,),
                                       (224, 224, 3)])
    def test_normalize_chain_bitwise(self, shape):
        x = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
        _assert_bitwise(_port_fused(x, NORMALIZE), _jax_fused(x, NORMALIZE))

    def test_integer_chain_exact(self):
        x = np.random.default_rng(1).integers(-50, 50, (300,)).astype(np.int32)
        ops = [("mul", 3), ("sub", 7), ("clamp", (-100, 100))]
        got = _port_fused(x, ops)
        _assert_bitwise(got, _jax_fused(x, ops))
        np.testing.assert_array_equal(got, np.clip(x * 3 - 7, -100, 100))

    def test_out_dtype_matches_jax(self):
        x = np.ones((5,), np.int16)
        ops = [("add", 1)]
        _assert_bitwise(_port_fused(x, ops), _jax_fused(x, ops))
        for dt in (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
                   np.float16, np.float32, np.int64, np.float64):
            for ops in ([("add", 1)], [("add", 1.5)], [("div", 2)], [("mul", -1)],
                        [("clamp", (0, 1))], [("clamp", (0, 1.0))],
                        [("typecast", np.int64)], NORMALIZE):
                assert K.chain_out_dtype(dt, ops) == np.dtype(jk.chain_out_dtype(dt, ops)), (dt, ops)

    def test_empty(self):
        got = K.fused_arith(torch.zeros((0, 3)), [("add", 1.0)])
        assert tuple(got.shape) == (0, 3)

    # The promotion cases of tests/test_pallas_quant.py:278,301,321, through
    # the kernel with the literals bound as the transform binds them.
    @pytest.mark.parametrize("x,option", [
        (np.array([0, 1, 200, 255], np.uint8), "add:-128"),
        (np.array([0, 1, 2, 3], np.uint8), "clamp:-1:1"),
        (np.arange(8, dtype=np.uint8), "div:2.0"),
    ])
    def test_promotion_cases_bitwise(self, x, option):
        if option.startswith("clamp:"):
            raw = [("clamp", _parse_clamp(option[6:]))]
        else:
            raw = _parse_arith_ops(option)
        ops = _bind_chain(raw, x.dtype)
        assert ops == jax_bind_chain(raw, x.dtype)
        got = _port_fused(x, ops)
        _assert_bitwise(got, _jax_fused(x, ops))
        assert got.dtype == np.float32

    # Chains where every step rounds once in both packages: bitwise for every
    # dtype the kernel takes, odd length, NaN/inf/-0.0 in the float inputs.
    @pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.uint16, np.int16,
                                       np.uint32, np.int32, np.float16, np.float32])
    @pytest.mark.parametrize("option", [
        "typecast:float32,add:-127.5,div:127.5", "add:200", "add:-128", "mul:300",
        "typecast:int8,add:1", "typecast:uint8", "typecast:int32,mul:70000,add:5",
        "div:3.0", "typecast:uint16", "clamp:-1:1", "clamp:-100.5:200.5", "clamp:10:5",
    ])
    def test_single_rounding_chains_bitwise(self, dtype, option):
        rng = np.random.default_rng(3)
        dt = np.dtype(dtype)
        if np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            x = rng.integers(info.min, info.max, 517, endpoint=True).astype(dt)
        else:
            x = (rng.standard_normal(517) * 300).astype(dt)
            x[:5] = [np.nan, np.inf, -np.inf, -0.0, 0.0]
        if option.startswith("clamp:"):
            ops = _bind_chain([("clamp", _parse_clamp(option[6:]))], dt)
        else:
            ops = _bind_chain(_parse_arith_ops(option), dt)
        _assert_bitwise(_port_fused(x, ops), _jax_fused(x, ops))

    def test_division_by_literal_is_a_reciprocal_multiply(self):
        """JAX compiles ``x / 127.5`` into ``x * f32(1/127.5)`` (XLA's
        algebraic simplifier), so IEEE division would miss it in the last
        bit for 126 of the 256 uint8 inputs of the normalize chain; the
        port multiplies by the same reciprocal."""
        x = np.arange(256, dtype=np.uint8)
        want = _jax_fused(x, NORMALIZE)
        centered = x.astype(np.float32) - np.float32(127.5)
        reciprocal = centered * (np.float32(1) / np.float32(127.5))
        ieee = centered / np.float32(127.5)
        np.testing.assert_array_equal(want, reciprocal)
        assert np.count_nonzero(want != ieee) == 126
        _assert_bitwise(_port_fused(x, NORMALIZE), want)

    def test_multiply_add_within_one_rounding(self):
        """XLA on the CPU contracts ``x*3 - 7`` into one fused multiply-add;
        the port (and its CUDA kernel) rounds after each step.  With no
        cancellation (x in [10, 300]) the two differ by at most 1 ulp."""
        x = np.random.default_rng(4).uniform(10, 300, 999).astype(np.float32)
        ops = [("mul", 3), ("sub", 7)]
        np.testing.assert_array_max_ulp(_port_fused(x, ops), _jax_fused(x, ops), maxulp=1)

    def test_unsupported_dtypes_raise(self):
        for dtype in (torch.int64, torch.float64, torch.bool, torch.complex64):
            with pytest.raises(TypeError):
                K.fused_arith(torch.zeros(4, dtype=dtype), [("add", 1)])
        with pytest.raises(TypeError):
            K.fused_arith(np.zeros(4, np.float32), [("add", 1)])
        with pytest.raises(ValueError):
            K.fused_arith(torch.zeros(4, 4).t(), [("add", 1)])
        with pytest.raises(ValueError):
            K.fused_arith(torch.zeros(4), [("add", 1)] * (K.MAX_STEPS + 1))

    def test_non_cpu_tensor_never_takes_plain_path(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("plain version called")

        monkeypatch.setattr(K, "run_chain", boom)
        with pytest.raises(ValueError, match="unsupported device"):
            K.fused_arith(torch.zeros(4, device="meta"), [("add", 1)])


DTYPES = [np.dtype(d) for d in (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
                                 np.float16, np.float32)]


def _extreme_inputs(dt: np.dtype, rng, n: int = 61) -> np.ndarray:
    """Random values of ``dt`` with its extremes: int min/max, 0, +-1; for
    floats NaN, +-inf, -0.0, the float16 limits and values beyond them."""
    if dt.kind in "iu":
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, endpoint=True).astype(dt)
        special = [info.min, info.max, 0, 1, info.max - 1, info.min + 1] + ([-1] if dt.kind == "i" else [])
    else:
        x = (rng.standard_normal(n) * 300).astype(dt)
        special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 65504.0, -65520.0, 0.5, -2.5, 3e9, -3e9]
        if dt == np.float32:
            special += [7e4, 2.0 ** 31, -(2.0 ** 31) - 512, 4.3e9, 1e38]
    with np.errstate(over="ignore"):  # beyond float16: inf
        x[:len(special)] = np.array(special).astype(dt)
    return x


_LITERAL = st.one_of(st.integers(-300, 300), st.sampled_from([0, 1, -1, 2 ** 31 - 1, -(2 ** 31), 2 ** 32 - 1, 70000]),
                     st.floats(-1e4, 1e4, allow_nan=False, width=32), st.sampled_from([0.5, -0.0, 127.5, 1e-3]))
_STEP = st.one_of(
    st.tuples(st.just("typecast"), st.sampled_from(DTYPES)),
    st.tuples(st.sampled_from(["add", "sub", "mul"]), _LITERAL),
    st.tuples(st.just("div"), _LITERAL.filter(lambda v: v != 0)),
    st.tuples(st.just("clamp"), st.tuples(_LITERAL, _LITERAL)),
)


_STEP_BF = st.one_of(_STEP, st.tuples(st.just("typecast"), st.sampled_from(DTYPES + [BFLOAT16])))
J_BF16 = np.dtype(ml_dtypes.bfloat16)


def _with_bf16(bf_in, dt, ops, pos):
    """A bfloat16 input, or a typecast to bfloat16 inserted at ``pos``."""
    if bf_in:
        return BFLOAT16, ops
    return dt, ops[:pos] + [("typecast", BFLOAT16)] + ops[pos:]


# bfloat16 subnormals: the least, the greatest and two between, both signs
BF16_SUBNORMAL_BITS = [0x0001, 0x8001, 0x007F, 0x807F, 0x002E, 0x803F]


def _inputs(dt, rng, n: int = 61) -> np.ndarray:
    """:func:`_extreme_inputs`; for bfloat16 the bits of random values with
    NaN, +-inf, -0.0, values near the float32 limits and subnormals (which
    float arithmetic flushes, as XLA does: C6)."""
    if dt != BFLOAT16:
        return _extreme_inputs(dt, rng, n)
    x = (rng.standard_normal(n) * 300).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 65504.0, 0.5, -2.5, 3e9, -3e9, 7e4,
               2.0 ** 31, -(2.0 ** 31) - 512, 4.3e9, 1e38, 3.3e38]
    x[:len(special)] = special
    bits = K.bf16_bits(x)
    bits[len(special):len(special) + len(BF16_SUBNORMAL_BITS)] = BF16_SUBNORMAL_BITS
    return bits


def _subnormal(x: np.ndarray, dt) -> np.ndarray:
    """Where ``x`` (bfloat16 as its bits) holds a float32 subnormal."""
    v = K.bf16_value(x) if dt == BFLOAT16 else x
    if v.dtype != np.float32:
        return np.zeros(v.shape, bool)
    return (v != 0) & (np.abs(v) < np.finfo(np.float32).tiny)


def _flushed(x: np.ndarray, dt) -> np.ndarray:
    """``x`` with its float32 subnormals replaced by zeros of their sign."""
    sub = _subnormal(x, dt)
    if dt == BFLOAT16:
        return np.where(sub, x & np.uint16(0x8000), x)
    return np.where(sub, np.copysign(np.float32(0), x), x)


def _against_xla(got, want, out_dtype) -> None:
    """The port's result ``got`` against XLA's ``want``, bit for bit on
    every lane, subnormal inputs included (C6, repaired: the port flushes
    them in float arithmetic as XLA does)."""
    _bitwise(_values(got, out_dtype), _values(want, out_dtype))


def _values(a: np.ndarray, dt) -> np.ndarray:
    """Comparable values: bfloat16 bits as float32."""
    return K.bf16_value(a) if dt == BFLOAT16 else a


def _plain(x: np.ndarray, dt, ops) -> np.ndarray:
    t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) if dt == BFLOAT16 \
        else torch.from_numpy(x)
    out = K.fused_arith_plain(t, ops)
    return out.view(torch.int16).numpy().view(np.uint16) if out.dtype == torch.bfloat16 \
        else out.numpy()


def _jax_bf16(x: np.ndarray, dt, ops) -> np.ndarray:
    """The Pallas kernel on bits and chains of the port's BFLOAT16.  A
    chain JAX refuses (an int literal beyond int32 on a float stream) is
    no example."""
    ops = [(op, J_BF16 if v == BFLOAT16 else v) for op, v in ops]
    try:
        out = _jax_fused(x.view(J_BF16) if dt == BFLOAT16 else x, ops)
    except OverflowError:
        assume(False)
    return out.view(np.uint16) if out.dtype == J_BF16 else out


def _bitwise(got: np.ndarray, want: np.ndarray) -> None:
    """Equal bit for bit, but any NaN equals any NaN: the card and the CPU
    may give a NaN another payload."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        nan = np.isnan(got)
        np.testing.assert_array_equal(nan, np.isnan(want))
        bits = np.uint16 if got.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(got[~nan].view(bits), want[~nan].view(bits))
    else:
        np.testing.assert_array_equal(got, want)


class TestChainProgram:
    """The chain as the kernel computes it (``ops/kernels.py::program_eval``,
    both variants) against the plain version and the Pallas kernel."""

    @settings(max_examples=150, deadline=None, derandomize=True, database=None)
    @given(dt=st.sampled_from(DTYPES), ops=st.lists(_STEP, min_size=1, max_size=K.MAX_STEPS),
           bind=st.booleans(), seed=st.integers(0, 2 ** 16))
    def test_program_bitwise_against_plain(self, dt, ops, bind, seed):
        """Chains of 1 to 8 steps, bound as the transform binds them or taken
        raw (int literals beyond the stream's range, clamp bounds outside
        it): the model of the kernel is bitwise the plain version, and the
        float32-chain variant equals the general one on its chains."""
        if bind:
            ops = _bind_chain(ops, dt)
        x = _extreme_inputs(dt, np.random.default_rng(seed))
        plan = K.fused_arith_plan(dt, ops)
        prog = plan.program
        want = K.fused_arith_plain(torch.from_numpy(x), ops).numpy()
        _bitwise(K.program_eval(x, prog, plan.out_dtype), want)
        if prog.variant == K.FLOAT_CHAIN:
            assert plan.out_dtype == np.float32
            general = prog._replace(variant=K.GENERAL)
            _bitwise(K.program_eval(x, general, plan.out_dtype), want)
        assert {K.CONV["none"], K.CONV["f2h"], K.CONV["f2b"], K.CONV["wrap_u8"], K.CONV["wrap_i8"],
                K.CONV["wrap_u16"], K.CONV["wrap_i16"]} >= set(prog.post)

    @settings(max_examples=24, deadline=None, derandomize=True, database=None)
    @given(dt=st.sampled_from(DTYPES), ops=st.lists(_STEP, min_size=1, max_size=K.MAX_STEPS),
           seed=st.integers(0, 2 ** 16))
    def test_program_bitwise_against_pallas(self, dt, ops, seed):
        """Bound chains where every float result rounds once in both
        packages (at most one float add/sub/mul/div, none in float16: XLA
        on the CPU fuses a multiply-add and keeps float16 chains in float32)
        against the Pallas kernel in interpret mode."""
        ops = _bind_chain(ops, dt)
        plan = K.fused_arith_plan(dt, ops)
        rounding = [step_dt for op, step_dt, _, _ in plan.steps
                    if op in ("add", "sub", "mul") and step_dt.kind == "f"]
        assume(len(rounding) <= 1 and np.dtype(np.float16) not in rounding)
        x = _extreme_inputs(dt, np.random.default_rng(seed), n=37)
        _bitwise(K.program_eval(x, plan.program, plan.out_dtype), _jax_fused(x, ops))

    # bfloat16 in, out or in between: the input's bits, or a typecast
    # inserted into the chain.
    @settings(max_examples=120, deadline=None, derandomize=True, database=None)
    @given(bf_in=st.booleans(), dt=st.sampled_from(DTYPES),
           ops=st.lists(_STEP_BF, min_size=0, max_size=K.MAX_STEPS - 1),
           pos=st.integers(0, K.MAX_STEPS - 1), bind=st.booleans(), seed=st.integers(0, 2 ** 16))
    def test_bf16_program_bitwise_against_plain(self, bf_in, dt, ops, pos, bind, seed):
        dt, ops = _with_bf16(bf_in, dt, ops, pos)
        if bind:
            ops = _bind_chain(ops, dt)
        x = _inputs(dt, np.random.default_rng(seed))
        plan = K.fused_arith_plan(dt, ops)
        want = _plain(x, dt, ops)
        _bitwise(_values(K.program_eval(x, plan.program, plan.out_dtype, in_dtype=dt),
                         plan.out_dtype), _values(want, plan.out_dtype))

    @settings(max_examples=40, deadline=None, derandomize=True, database=None)
    @given(bf_in=st.booleans(), dt=st.sampled_from(DTYPES),
           ops=st.lists(_STEP_BF, min_size=0, max_size=K.MAX_STEPS - 1),
           pos=st.integers(0, K.MAX_STEPS - 1), seed=st.integers(0, 2 ** 16))
    def test_bf16_program_bitwise_against_pallas(self, bf_in, dt, ops, pos, seed):
        """As above against the Pallas kernel in interpret mode: XLA rounds
        a bfloat16 result after every step, so any number of bfloat16 steps
        (float32 and float16 steps as in the test above)."""
        dt, ops = _with_bf16(bf_in, dt, ops, pos)
        ops = _bind_chain(ops, dt)
        plan = K.fused_arith_plan(dt, ops)
        rounding = [step_dt for op, step_dt, _, _ in plan.steps
                    if op in ("add", "sub", "mul") and step_dt.kind == "f" and step_dt != BFLOAT16]
        assume(len(rounding) <= 1 and np.dtype(np.float16) not in rounding)
        x = _inputs(dt, np.random.default_rng(seed), n=37)

        _against_xla(K.program_eval(x, plan.program, plan.out_dtype, in_dtype=dt),
                     _jax_bf16(x, dt, ops), plan.out_dtype)

    @pytest.mark.parametrize("dt", [np.uint8, BFLOAT16])
    def test_normalize_to_bf16_bitwise(self, dt):
        """The normalize chain ending in ``typecast:bfloat16``, and the
        plain normalize on a bfloat16 frame, against the Pallas kernel."""
        rng = np.random.default_rng(5)
        x = rng.integers(0, 256, (224, 224, 3)).astype(np.uint8) if dt == np.uint8 \
            else _inputs(BFLOAT16, rng, 4099)
        for option in ("typecast:float32,add:-127.5,div:127.5,typecast:bfloat16",
                       "typecast:bfloat16,add:-127.5,div:127.5"):
            ops = _bind_chain(_parse_arith_ops(option), dt)
            plan = K.fused_arith_plan(dt, ops)
            assert plan.out_dtype == BFLOAT16
            want = _jax_bf16(x, dt, ops)
            _against_xla(_plain(x, dt, ops), want, BFLOAT16)
            _against_xla(K.program_eval(x, plan.program, BFLOAT16, in_dtype=dt), want, BFLOAT16)

    def test_int_to_bf16_rounds_through_float32(self):
        """XLA converts an int32 to bfloat16 through float32: two roundings.
        2**24 + 2**16 + 1 rounds to 2**24 + 2**16 in float32, a tie that goes
        to the even 2**24 (rounded once it would be 2**24 + 2**17); odd values
        near 2**31 round to 2**31."""
        x = np.array([2 ** 24 + 1, 2 ** 24 + 2 ** 16 + 1, 2 ** 25 + 2 ** 17 + 1,
                      -(2 ** 25 + 2 ** 17 + 1), 2 ** 31 - 1, 2 ** 31 - 3, -(2 ** 31) + 1,
                      2 ** 31 - 2 ** 22 - 1], np.int32)
        ops = [("typecast", BFLOAT16)]
        want = _values(_jax_bf16(x, np.dtype(np.int32), ops), BFLOAT16)
        np.testing.assert_array_equal(want[:5], [2 ** 24, 2 ** 24, 2 ** 25, -(2 ** 25), 2 ** 31])
        plan = K.fused_arith_plan(np.int32, ops)
        _bitwise(_values(_plain(x, np.dtype(np.int32), ops), BFLOAT16), want)
        _bitwise(_values(K.program_eval(x, plan.program, BFLOAT16), BFLOAT16), want)

    def test_bf16_division_keeps_a_float32_reciprocal(self):
        """x / 3 on every bfloat16: the float32 reciprocal, not one rounded
        to bfloat16 (which misses for hundreds of inputs)."""
        x = np.arange(65536, dtype=np.uint32).astype(np.uint16)
        v = K.bf16_value(x)
        x = x[np.isfinite(v) & ((np.abs(v) >= np.float32(2.0 ** -120)) | (v == 0))]
        ops = [("div", 3)]
        want = _values(_jax_bf16(x, BFLOAT16, ops), BFLOAT16)
        _bitwise(_values(_plain(x, BFLOAT16, ops), BFLOAT16), want)
        rounded = K.bf16_round(np.float32(1) / K.bf16_round(np.float32(3)))
        assert np.count_nonzero(K.bf16_round(K.bf16_value(x) * rounded) != want) > 100

    @pytest.mark.parametrize("dt", [np.dtype(np.float32), np.dtype(np.float16), BFLOAT16])
    @pytest.mark.parametrize("ops", [[("clamp", (-0.0, 1.0))], [("clamp", (-1.0, 0.0))],
                                     [("clamp", (-1, -0.0))], [("clamp", (0, 5))],
                                     [("add", 0)], [("sub", -0.0)], [("add", 0.0), ("mul", 2)]])
    def test_signed_zeros_as_xla_orders_them(self, dt, ops):
        """XLA's max and min order -0.0 below +0.0, and it folds x + 0 and
        x - 0 into x: on +-0.0 inputs the plain version and the kernel's
        program give the Pallas kernel's signs."""
        v = np.array([-0.0, 0.0, -0.0, 0.0, 1.5, -1.5, np.nan], np.float32)
        x = K.bf16_bits(v) if dt == BFLOAT16 else v.astype(dt)
        want = _values(_jax_bf16(x, dt, ops), dt)
        plan = K.fused_arith_plan(dt, ops)
        _bitwise(_values(_plain(x, dt, ops), dt), want)
        _bitwise(_values(K.program_eval(x, plan.program, dt, in_dtype=dt), dt), want)

    @pytest.mark.parametrize("dt", [np.dtype(np.float32), BFLOAT16])
    @pytest.mark.parametrize("ops,flushes", [
        ([("mul", 2)], True), ([("div", 2)], True), ([("add", 2e-38)], True),
        ([("clamp", (-1.0, 1.0))], True), ([("typecast", np.float32)], False),
        ([("typecast", BFLOAT16)], False), ([("add", 0.0)], False), ([("mul", 1)], False),
        ([("sub", 1e-39)], True), ([("clamp", (-1.0, 0.0))], True), ([("mul", -1)], False),
        ([("div", 1)], False), ([("clamp", (-np.inf, np.inf))], False),
        ([("clamp", (-np.inf, 1.0))], True), ([("mul", 1e-39)], True)])
    def test_subnormals_xla_flushes_the_port_keeps(self, dt, ops, flushes):
        """C6, repaired: XLA (on the CPU, as the TPU) flushes float32 and
        bfloat16 subnormals in float arithmetic, each operand and each
        result to a zero of its sign; a typecast, and the steps XLA folds
        away (``x + 0``, ``x * 1``, ``x * -1`` as a sign flip,
        ``clamp(-inf, inf)``), keep them.  The plain version and the
        kernel's program now give XLA's bits; ``flushes`` says which of the
        two a step does."""
        if dt == BFLOAT16:
            x = np.array(BF16_SUBNORMAL_BITS[:5] + [0x4000], np.uint16)  # ..., 2.0
        else:
            x = np.array([1e-39, -1e-39, 1.4e-45, -5.8e-39, 1.1754942e-38, 2.0], np.float32)
        sub = _subnormal(x, dt)
        assert sub[:5].all() and not sub[5]
        ops = [(op, BFLOAT16 if isinstance(val, type) and val is BFLOAT16 else val)
               for op, val in ops]
        plan = K.fused_arith_plan(dt, ops)
        plain = _plain(x, dt, ops)
        xla = _jax_bf16(x, dt, ops)
        _bitwise(_values(plain, plan.out_dtype), _values(xla, plan.out_dtype))
        _bitwise(_values(K.program_eval(x, plan.program, plan.out_dtype, in_dtype=dt),
                         plan.out_dtype), _values(xla, plan.out_dtype))
        flushed = _values(_plain(_flushed(x, dt), dt, ops), plan.out_dtype)[sub]
        kept = _values(plain, plan.out_dtype)[sub]
        assert np.array_equal(kept.view(np.uint32), flushed.view(np.uint32)) == flushes

    def test_plan_cache_tells_equal_literals_apart(self):
        """0, 0.0 and -0.0 compare equal, so a cache keyed by the chain
        alone handed ``add:0.0`` the plan of ``add:0`` (uint8 out, where
        JAX gives float32) and a clamp at 0 the plan of one at -0.0."""
        u8 = np.dtype(np.uint8)
        assert K.plan_chain(u8, (("add", 0),)).out_dtype == np.uint8
        assert K.plan_chain(u8, (("add", 0.0),)).out_dtype == np.float32
        assert K.plan_chain(BFLOAT16, (("clamp", (-0.0, 1)),)).program.a == (1 << 31,)
        assert K.plan_chain(BFLOAT16, (("clamp", (0, 1)),)).program.a == (0,)

    def test_variants(self):
        norm = K.fused_arith_plan(np.uint8, NORMALIZE).program
        assert norm.variant == K.FLOAT_CHAIN
        assert norm.conv[0] == K.CONV["i2f"]
        assert norm.op == (K.OP["none"], K.OP["fadd"], K.OP["fmul"])
        assert norm.a[1:] == (int(np.float32(-127.5).view(np.uint32)),
                              int(np.float32(1 / np.float32(127.5)).view(np.uint32)))
        assert K.fused_arith_plan(np.int32, [("mul", 3)]).program.variant == K.GENERAL
        assert K.fused_arith_plan(np.float16, [("add", 1.0)]).program.variant == K.GENERAL
        assert K.fused_arith_plan(np.float32, []).program.variant == K.GENERAL

    @pytest.mark.parametrize("dt,lo,hi,want", [
        (np.int8, -1000, 1000, (-128, 127)), (np.int8, 300, 400, (44, 44)),
        (np.int8, 300, 200, (-56, -56)), (np.uint8, -5, -3, (253, 253)),
        (np.uint8, 10, 5, (10, 5)), (np.uint32, -1, 2 ** 40, (0, 2 ** 32 - 1)),
        (np.int16, -(2 ** 40), 7, (-32768, 7))])
    def test_int_clamp_bounds_move_into_range(self, dt, lo, hi, want):
        assert K._int_clamp(lo, hi, np.dtype(dt)) == want
        info = np.iinfo(dt)
        x = np.array([info.min, -1 if info.min else 0, 0, 7, info.max], dt)
        ops = [("clamp", (lo, hi))]
        plan = K.fused_arith_plan(dt, ops)
        _bitwise(K.program_eval(x, plan.program, plan.out_dtype),
                 K.fused_arith_plain(torch.from_numpy(x), ops).numpy())

    def test_ctypes_program_matches_the_cuda_struct(self):
        import ctypes

        src = (Path(K.__file__).resolve().parent.parent / "csrc" / "fused_arith.cu").read_text()
        body = re.search(r"struct Program \{(.*?)\};", src, re.S).group(1)
        fields = re.findall(r"^\s*(int|uint32_t) (\w+)(\[kMaxSteps\])?;", body, re.M)
        assert [f[1] for f in fields] == [f[0] for f in K._Program._fields_]
        for (ctype, name, array), (_, pytype) in zip(fields, K._Program._fields_):
            base = ctypes.c_int if ctype == "int" else ctypes.c_uint32
            assert pytype == (base * K.MAX_STEPS if array else base), name
        assert ctypes.sizeof(K._Program) == 8 + 5 * 4 * K.MAX_STEPS
        prog = K.fused_arith_plan(np.uint8, NORMALIZE).c_program
        assert (prog.variant, prog.n_steps, list(prog.op)) == (K.FLOAT_CHAIN, 3, [0, 6, 8] + [0] * 5)

    def test_cuda_source_names_the_same_codes(self):
        src = (Path(K.__file__).resolve().parent.parent / "csrc" / "fused_arith.cu").read_text()

        def enum(name, prefix):
            body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
            return {k[len(prefix):].lower(): int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}

        assert enum("Conv", "C_") == K.CONV
        assert enum("Op", "O_") == K.OP
        assert enum("Variant", "") == {"float_chain": K.FLOAT_CHAIN, "general": K.GENERAL}
        assert enum("Dt", "") == {("bf" if d == BFLOAT16 else d.name[0]) + str(d.itemsize * 8): c
                                  for d, c in K._DT_CODES.items()}


# (in dtype, out dtype) pairs of every width, each once.
SIZE_PAIRS = [(np.uint8, np.float32), (np.float32, np.uint8), (np.uint8, np.uint8),
              (np.int16, np.float32), (np.float32, np.float16), (np.float16, np.float32),
              (np.int8, np.int16), (np.int32, np.int32), (np.uint16, np.int8)]


class TestFusedGeometry:
    @pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 64, 1000, 224 * 224 * 3, 300 * 300 * 3])
    @pytest.mark.parametrize("in_dt,out_dt", SIZE_PAIRS)
    def test_every_element_written_once(self, n, in_dt, out_dt):
        """For every input offset of 0 to 15 bytes (element-aligned) and an
        output at a fresh allocation: every element is read and written by
        exactly one access, every vector access is 16-byte aligned on the
        input and aligned to its store width on the output, nothing lies
        past ``n``, and the grid has no block without work."""
        in_size, out_size = np.dtype(in_dt).itemsize, np.dtype(out_dt).itemsize
        vec = K.VEC_BYTES // in_size
        unit = min(K.VEC_BYTES, vec * out_size)
        for x_off in range(0, 16, in_size):
            x_ptr, y_ptr = 4096 + x_off, 8192
            geo = K.fused_arith_geometry(n, in_size, out_size, x_ptr, y_ptr)
            assert geo.head + geo.nvec * vec + geo.tail == n and geo.threads == K.THREADS
            starts, scalars = K.fused_arith_accesses(in_size, geo)
            assert ((x_ptr + starts * in_size) % K.VEC_BYTES == 0).all()
            assert ((y_ptr + starts * out_size) % unit == 0).all()
            covered = np.concatenate([(starts[:, None] + np.arange(vec)).ravel(), scalars])
            assert covered.size == n and (covered >= 0).all() and (covered < n).all()
            np.testing.assert_array_equal(np.bincount(covered, minlength=n), np.ones(n))
            assert (geo.blocks - 1) * geo.threads < max(geo.nvec, geo.head + geo.tail, 1)
            if geo.nvec:
                assert geo.head < vec and geo.tail < vec

    def test_grid_sized_to_the_card(self):
        """One vector per thread: the path's frames run in one wave on 132
        SMs (74 and 132 blocks of 128 threads), a 4K frame in 12,150
        blocks."""
        assert K.fused_arith_geometry(224 * 224 * 3, 1, 4, 0, 0) == (0, 9408, 0, 74, 128)
        assert K.fused_arith_geometry(300 * 300 * 3, 1, 4, 0, 0) == (0, 16875, 0, 132, 128)
        n = 2160 * 3840 * 3
        big = K.fused_arith_geometry(n, 1, 4, 0, 0)
        assert big == (0, n // 16, 0, 12150, 128)
        starts, scalars = K.fused_arith_accesses(1, big)
        assert scalars.size == 0
        np.testing.assert_array_equal(starts, np.arange(big.nvec) * 16)
        # misaligned by a byte: the output cannot share the input's phase
        assert K.fused_arith_geometry(1000, 1, 4, 1, 0) == (1000, 0, 0, 8, 128)
        # by four bytes it can, twelve elements on
        assert K.fused_arith_geometry(1000, 1, 4, 4, 0) == (12, 61, 12, 1, 128)
        assert K.fused_arith_geometry(1000, 1, 1, 1, 1) == (15, 61, 9, 1, 128)
        assert K.fused_arith_geometry(100, 4, 4, 4, 4) == (3, 24, 1, 1, 128)

    def test_staged_stores_write_each_piece_once(self):
        """The kernel's shared-memory slots (``slot`` in the .cu) for 2 and
        4 pieces a vector: a warp's 32 x kParts pieces land in distinct
        slots, and each group of 8 lanes (one 128-byte wavefront of 16-byte
        accesses) touches all 32 banks once, writing and reading."""
        for parts in (2, 4):
            def slot(vec, part):
                return vec * parts + ((part + vec // (8 // parts)) % parts)

            lanes = np.arange(32)
            writes = np.stack([slot(lanes, i) for i in range(parts)])
            assert sorted(writes.ravel()) == list(range(32 * parts))
            c = np.arange(32 * parts)
            reads = slot(c // parts, c % parts)
            np.testing.assert_array_equal(np.sort(reads), np.arange(32 * parts))
            for s in list(writes) + [reads[i * 32:(i + 1) * 32] for i in range(parts)]:
                for g in range(4):
                    banks = (s[8 * g:8 * g + 8, None] * 4 + np.arange(4)) % 32
                    assert sorted(banks.ravel()) == list(range(32))

    def test_cuda_source_names_the_same_geometry(self):
        src = (Path(K.__file__).resolve().parent.parent / "csrc" / "fused_arith.cu").read_text()
        consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
        assert consts == {"kMaxSteps": K.MAX_STEPS, "kThreads": K.THREADS,
                          "kVecBytes": K.VEC_BYTES}
        assert "__launch_bounds__(kThreads)" in src
        assert "return vec * kParts + ((part + vec / (8 / kParts)) % kParts);" in src
        assert "const __grid_constant__ Program p" in src


def _int8_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random((1, n)) * 0.01 + 1e-4).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    xs = np.float32(rng.random() * 0.1 + 1e-3)
    return xq, wq, xs, ws, b


INT8_SHAPES = [(1, 1280, 1001), (3, 1280, 1001), (33, 64, 10), (300, 1280, 256)]


class TestInt8Matmul:
    @pytest.mark.parametrize("m,k,n", INT8_SHAPES)
    def test_int32_accumulator_exact(self, m, k, n):
        """Unit scales and zero bias leave the int32 accumulator, which is
        exactly representable in float32 here (|acc| < 2**24)."""
        xq, wq, _, _, _ = _int8_operands(m, k, n, seed=m + n)
        ones = np.ones((1, n), np.float32)
        want = np.asarray(jk.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), 1.0,
                                         jnp.asarray(ones), jnp.zeros((n,), jnp.float32)))
        got = K.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq), torch.tensor(1.0),
                            torch.from_numpy(ones), torch.zeros(n)).numpy()
        acc = xq.astype(np.int64) @ wq.astype(np.int64)
        assert np.abs(acc).max() < 2 ** 24
        np.testing.assert_array_equal(got.astype(np.int64), acc)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("m,k,n", INT8_SHAPES)
    def test_float_epilogue(self, m, k, n):
        """``acc * (xs * ws) + b`` rounds the product and the sum separately
        in the port: bitwise equal to numpy's float32 arithmetic.  XLA on the
        CPU fuses the product and the sum into one multiply-add, so JAX's
        result and the port's each carry rounding errors of at most half an
        ulp of the product and one ulp of the result: they differ by at most
        ``ulp(acc * (xs * ws)) + ulp(result)`` (many ulps of a result that
        cancels)."""
        xq, wq, xs, ws, b = _int8_operands(m, k, n, seed=7 * m + n)
        acc = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
        prod = acc * (xs * ws)
        for bias in (b, None):
            want = np.asarray(jk.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), xs, jnp.asarray(ws),
                                             None if bias is None else jnp.asarray(bias)))
            got = K.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq), torch.tensor(xs),
                                torch.from_numpy(ws),
                                None if bias is None else torch.from_numpy(bias)).numpy()
            exact = prod + (np.zeros(n, np.float32) if bias is None else bias)
            np.testing.assert_array_equal(got, exact)
            tol = np.spacing(np.abs(prod)) + np.spacing(np.abs(got))
            assert np.all(np.abs(got - want) <= tol), (m, k, n)

    def test_bad_operands_raise(self):
        xq, wq, xs, ws, b = (torch.from_numpy(a) if isinstance(a, np.ndarray) else torch.tensor(a)
                             for a in _int8_operands(2, 16, 8, seed=0))
        good = dict(x_q=xq, w_q=wq, x_scale=xs, w_scale=ws, bias=b)
        K.int8_matmul(**good)
        for key, bad, exc in [
            ("x_q", xq.float(), TypeError), ("w_q", wq.to(torch.int16), TypeError),
            ("x_scale", xs.double(), TypeError), ("bias", b.half(), TypeError),
            ("w_q", wq[:8], ValueError), ("w_scale", ws[:, :4].contiguous(), ValueError),
            ("x_q", xq.t().contiguous().t(), ValueError),
            ("x_scale", torch.ones(2), ValueError), ("x_q", xq.to("meta"), ValueError),
        ]:
            with pytest.raises(exc):
                K.int8_matmul(**{**good, key: bad})
        with pytest.raises(ValueError, match="unsupported device"):
            K.int8_matmul(*(t.to("meta") for t in (xq, wq, xs, ws, b)))


def _misaligned_weight(wq: np.ndarray, offset: int = 1) -> torch.Tensor:
    """``wq`` as a contiguous (k, n) view that starts ``offset`` bytes into
    its storage, so its data_ptr() is not 16-byte aligned."""
    k, n = wq.shape
    flat = torch.empty(k * n + offset, dtype=torch.int8)
    view = flat[offset:].view(k, n)
    view.copy_(torch.from_numpy(wq))
    return view


class TestInt8Geometry:
    @pytest.mark.parametrize("m,k,n", [(1, 1280, 1001), (16, 1280, 1001), (1, 1283, 1001),
                                       (3, 1280, 1001), (1, 64, 1001), (1, 7, 5), (1, 1, 1),
                                       (2, 5000, 70), (1, 0, 3)])
    def test_split_k_geometry(self, m, k, n):
        geo = K.int8_matmul_geometry(m, k, n)
        assert geo.branch == "splitk" and K.SPLIT_K == 8
        assert geo.k_per_rank % 4 == 0 and geo.k_per_rank * K.SPLIT_K >= k
        assert (geo.k_per_rank - 4) * K.SPLIT_K < max(k, 1)  # no rank is more than one word idle
        assert geo.grid == (K.SPLIT_K, -(-n // K.TILE_N))

    def test_branch_edge(self):
        assert K.int8_matmul_geometry(K.SMALL_M, 1280, 1001).branch == "splitk"
        assert K.int8_matmul_geometry(K.SMALL_M + 1, 1280, 1001).branch == "tiled"
        assert K.int8_matmul_geometry(300, 1280, 256) == ("tiled", 0, (8, 10))
        # the head's shape: 16 column tiles x 8 ranks of 160 rows = 128 blocks
        assert K.int8_matmul_geometry(1, 1280, 1001) == ("splitk", 160, (8, 16))

    @pytest.mark.parametrize("base", [0, 1, 7, 15, 16 * 1001])
    @pytest.mark.parametrize("m,k,n", [(1, 1280, 1001), (16, 1280, 1001), (1, 1283, 1001),
                                       (3, 1280, 1001), (1, 64, 1001), (1, 7, 5), (1, 1, 1),
                                       (2, 5000, 70), (4, 300, 64), (1, 33, 128)])
    def test_every_weight_byte_reaches_the_products_once(self, m, k, n, base):
        """The small-M branch's weight loads (the kernel's index math): no
        read leaves the tensor, every 16-byte copy is aligned in global and
        shared memory and fits its 80-byte shared row, and every byte of
        the (k, n) weight lands exactly once where the products read it,
        at ``(start & 15) + col`` of its segment's row.  The whole windows
        also bring neighbouring bytes of the same tensor, never into the
        columns the products read, and at most 15 beside each end of a
        segment."""
        vectors, singles, segs = K.weight_reads(m, k, n, base=base)
        size = k * n
        assert (vectors[:, 0] % 16 == 0).all() and (vectors[:, 1] % 16 == 0).all()
        assert (vectors[:, 1] + 16 <= K.SHARED_ROW).all()
        assert (singles[:, 1] >= 0).all() and (singles[:, 1] < K.SHARED_ROW).all()
        for addr, width in ((vectors[:, 0], 16), (singles[:, 0], 1)):
            assert (addr >= base).all() and (addr + width <= base + size).all()
        # every byte each copy brings, with the shared offset it lands at
        lanes = np.arange(16)
        addr = np.concatenate([(vectors[:, 0, None] + lanes).ravel(), singles[:, 0]])
        dst = np.concatenate([(vectors[:, 1, None] + lanes).ravel(), singles[:, 1]])
        seg = np.concatenate([np.repeat(vectors[:, 2], 16), singles[:, 2]])
        start, ncols = segs[seg, 0], segs[seg, 1]
        used = (addr >= start) & (addr < start + ncols)
        np.testing.assert_array_equal(dst[used], (start & 15)[used] + addr[used] - start[used])
        counts = np.bincount(addr[used] - base, minlength=size)
        np.testing.assert_array_equal(counts, np.ones(size, np.int64))
        extra = ~used
        assert ((dst[extra] < (start & 15)[extra])
                | (dst[extra] >= (start & 15)[extra] + ncols[extra])).all()
        assert (np.bincount(seg[extra], minlength=len(segs)) <= 30).all()
        if size >= 64 * 16:  # most of a large weight goes in 16-byte copies
            assert len(singles) <= 32

    def test_weight_reads_refuse_the_tiled_branch(self):
        with pytest.raises(ValueError, match="tiled"):
            K.weight_reads(17, 64, 64)

    def test_cuda_source_names_the_same_geometry(self):
        src = (Path(K.__file__).resolve().parent.parent / "csrc" / "int8_matmul.cu").read_text()
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
        assert int(consts["kMaxSmallM"]) == K.SMALL_M
        assert int(consts["kSplit"]) == K.SPLIT_K
        assert int(consts["kTileN"]) == K.TILE_N
        assert int(consts["kPassK"]) == K.PASS_K

    def test_float_operand_not_aligned_to_its_element_raises(self):
        """A float32 operand can start at an odd address (a buffer imported
        at a byte offset); the kernel reads it with float loads."""
        xq, wq, xs, ws, b = _int8_operands(1, 16, 4, seed=1)
        odd = torch.frombuffer(bytearray(1) + bytearray(b.tobytes()), dtype=torch.float32,
                               offset=1, count=4)
        assert odd.data_ptr() % 4 != 0
        with pytest.raises(ValueError, match="aligned"):
            K.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq), torch.tensor(xs),
                          torch.from_numpy(ws), odd)

    @pytest.mark.parametrize("m,k,n", [(1, 1280, 1001), (17, 64, 33)])
    def test_misaligned_weight_view_accepted(self, m, k, n):
        """A weight view whose data_ptr() is one byte past a 16-byte
        boundary is taken as it lies: the kernel finds the alignment of
        each row segment itself.  Same result as a fresh contiguous copy
        and as the JAX package."""
        xq, wq, xs, ws, b = _int8_operands(m, k, n, seed=3)
        view = _misaligned_weight(wq)
        assert view.is_contiguous() and view.storage_offset() == 1
        args = (torch.from_numpy(xq), view, torch.tensor(xs), torch.from_numpy(ws),
                torch.from_numpy(b))
        got = K.int8_matmul(*args).numpy()
        np.testing.assert_array_equal(got, K.int8_matmul_plain(
            torch.from_numpy(xq), torch.from_numpy(wq.copy()), *args[2:]).numpy())
        want = np.asarray(jk.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.float32(1.0),
                                         jnp.ones((1, n), jnp.float32),
                                         jnp.zeros((n,), jnp.float32)))
        ones = K.int8_matmul(torch.from_numpy(xq), view, torch.tensor(1.0),
                             torch.ones((1, n)), torch.zeros(n)).numpy()
        np.testing.assert_array_equal(ones, want)


def test_kernel_timing_tool_needs_a_gpu(monkeypatch, capsys):
    """The old-against-new timing tool refuses to run without a card: it
    measures nothing on the CPU."""
    from nnstreamer_tpu_torch.tools import kernel_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--parent", "."]) == 2
    assert "no CUDA GPU" in capsys.readouterr().err


NVCC_TIME_CSV = """source file name , phase name , phase input files , phase output file , arch , tool, metric , unit
fused_arith.cu , gcc (preprocessing 4) , fused_arith.cu  , a.ii ,  , nvcc , 403.1390 , ms
fused_arith.cu , cicc , a.ii  , a.ptx , compute_90a , nvcc , 28601.0 , ms
fused_arith.cu , ptxas , a.ptx  , a.cubin , sm_90a , nvcc , 34577.5 , ms
fused_arith.cu , cicc , b.ii  , b.ptx , compute_90a , nvcc , 1000.0 , ms
"""


def test_build_time_tool_reads_nvcc_phases():
    """``tools/build_time.py`` sums ``nvcc --time``'s rows by phase."""
    from nnstreamer_tpu_torch.tools.build_time import phase_seconds

    got = phase_seconds(NVCC_TIME_CSV)
    assert got == pytest.approx({"gcc (preprocessing 4)": 0.403139, "cicc": 29.601,
                                 "ptxas": 34.5775})
    assert phase_seconds("") == {}


def test_fused_arith_instantiates_by_width():
    """The general variant is instantiated per (input width, output width),
    the float32-chain variant per input dtype: 18 kernels, each dtype
    mapped to its width and to its widening and narrowing at run time."""
    src = (Path(K.__file__).resolve().parent.parent / "csrc" / "fused_arith.cu").read_text()
    general = set(re.findall(r"launch<(\w+), (\w+), false>", src))
    widths = {"InW"} | {"uint8_t", "uint16_t", "uint32_t"}
    assert {w for _, w in general} == {"uint8_t", "uint16_t", "uint32_t"}
    assert {w for w, _ in general} <= widths
    assert len(re.findall(r"launch_general<(\w+)>\(", src)) == 3
    float_chain = set(re.findall(r"launch<(\w+), float, true>", src))
    assert float_chain == {"uint8_t", "int8_t", "uint16_t", "int16_t", "uint32_t", "int32_t",
                           "f16", "float", "bf16"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fused_arith_matches_plain(cuda_device):
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (224, 224, 3)).astype(np.uint8))
    before = K.fused_arith.launches
    got = K.fused_arith(x.to(cuda_device), NORMALIZE)
    assert K.fused_arith.launches == before + 1
    want = K.fused_arith_plain(x.to(cuda_device), NORMALIZE)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), K.fused_arith(x, NORMALIZE))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("dtype,option", [
    (np.uint8, "typecast:float32,add:-127.5,div:127.5"), (np.int16, "typecast:float32,mul:0.5"),
    (np.uint8, "typecast:uint16,mul:300"), (np.float32, "typecast:int8"),
    (np.float16, "mul:3,add:0.1"), (np.uint32, "mul:65537,add:4000000000")])
def test_cuda_fused_arith_program_matches_plain(cuda_device, dtype, option, offset):
    """Both variants, staged and direct stores, aligned and offset inputs:
    the kernel equals the plain version and the model of its program."""
    x = _extreme_inputs(np.dtype(dtype), np.random.default_rng(9), n=70_001)
    ops = _bind_chain(_parse_arith_ops(option), np.dtype(dtype))
    flat = torch.empty(x.size + offset, dtype=torch.from_numpy(x).dtype, device=cuda_device)
    xd = flat[offset:].copy_(torch.from_numpy(x))
    got = K.fused_arith(xd, ops)
    _bitwise(got.cpu().numpy(), K.fused_arith_plain(xd, ops).cpu().numpy())
    plan = K.fused_arith_plan(np.dtype(dtype), ops)
    _bitwise(got.cpu().numpy(), K.program_eval(x, plan.program, plan.out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES + [(16, 1280, 1001), (17, 1280, 1001),
                                                 (1, 1283, 1001), (1, 7, 5)])
def test_cuda_int8_matmul_matches_plain(cuda_device, m, k, n, misaligned):
    ops = [torch.from_numpy(a) if isinstance(a, np.ndarray) else torch.tensor(a)
           for a in _int8_operands(m, k, n, seed=11)]
    if misaligned:
        ops[1] = _misaligned_weight(ops[1].numpy())
    dev = [t.to(cuda_device) for t in ops]
    before = K.int8_matmul.launches
    got = K.int8_matmul(*dev)
    assert K.int8_matmul.launches == before + 1
    assert torch.equal(got, K.int8_matmul_plain(*dev))
    assert torch.equal(got.cpu(), K.int8_matmul(*ops))

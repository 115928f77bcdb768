"""The port's two kernels against the JAX package's Pallas kernels.

Inputs are made with numpy from fixed seeds and go through
``nnstreamer_tpu.ops.pallas_kernels`` (Pallas interpret mode on the CPU, as
``tests/test_pallas_quant.py`` runs it) and through
``nnstreamer_tpu_torch.ops.kernels`` on CPU tensors, which take the plain
PyTorch versions.  The CUDA kernels themselves run only on a GPU: the tests
marked ``cuda`` hold them against the plain versions there and skip here.
``TestInt8Geometry`` checks the split-K launch geometry and the weight loads
of ``int8_matmul``'s small-M branch, in the kernel's own index math.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.elements.transform import _bind_chain as jax_bind_chain
from nnstreamer_tpu.ops import pallas_kernels as jk
from nnstreamer_tpu_torch.elements.transform import _bind_chain, _parse_arith_ops, _parse_clamp
from nnstreamer_tpu_torch.ops import kernels as K

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
        for dtype in (torch.int64, torch.float64, torch.bool, torch.bfloat16):
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

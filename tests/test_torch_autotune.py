"""The port's kernel autotune cache (``ops/autotune.py``) on the CPU.

Counterparts of the autotune cases of the JAX package's
``tests/test_compile_ahead.py`` (``TestAutotuneCache``): a winner's record
and its read back from disk, the platform in the key (here the GPU model,
``torch.cuda.get_device_name``), no cache dir, a corrupt table, a cached
winner steering the kernel's geometry without changing the numerics, and
the search refusing where it cannot time the kernel (the JAX package
refuses interpret mode; the port refuses a CPU device).  The consult is
read once a process: a later edit of the file shows only after
``refresh()``.  Each candidate geometry's partition of the int32 sums is
emulated in numpy and held bitwise against the plain version, and against
the JAX package's Pallas kernel in interpret mode within the epilogue's
rounding (as ``tests/test_torch_kernels.py`` holds the plain version).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops import pallas_kernels as jk

from nnstreamer_tpu_torch.ops import autotune
from nnstreamer_tpu_torch.ops import kernels as K

H100 = "NVIDIA H100 80GB HBM3"
OTHER = "NVIDIA A100-SXM4-80GB"
HEAD = (1, 1280, 1001)
BATCH = (32, 1280, 1001)


@pytest.fixture(autouse=True)
def _fresh_tables():
    autotune.refresh()
    yield
    autotune.refresh()


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("NNSTPU_COMPILE_CACHE_DIR", str(tmp_path))
    return tmp_path


class TestKey:
    def test_key_names_the_gpu_model(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
        key = autotune.make_key(((1, 1280), (1280, 1001)), "int8")
        assert key == f"1_1280x1280_1001|int8|{H100}"
        assert autotune.int8_key(*HEAD) == key
        assert autotune.int8_key(*HEAD, card=OTHER).endswith(f"|{OTHER}")

    def test_key_shape_matches_the_reference(self):
        from nnstreamer_tpu.ops import autotune as jautotune

        shapes = ((64, 128), (128, 256))
        assert (autotune.make_key(shapes, "int8", card="tpu")
                == jautotune.make_key(shapes, "int8", platform="tpu"))


class TestCache:
    def test_record_and_best_roundtrip(self, cache_dir):
        key = autotune.int8_key(*HEAD, card=H100)
        assert autotune.best(autotune.INT8_KERNEL, key) is None
        assert autotune.record(autotune.INT8_KERNEL, key, {"branch": "splitk", "split": 4},
                               metric_ms=0.0031)
        path = cache_dir / "autotune" / "int8_matmul.json"
        assert json.loads(path.read_text())[key]["split"] == 4
        autotune.refresh()  # a fresh process: read back from disk
        entry = autotune.best(autotune.INT8_KERNEL, key)
        assert entry["split"] == 4 and entry["ms"] == 0.0031
        assert autotune.cached_int8_geometry(*HEAD, H100) == K.splitk_geometry(*HEAD, 4)
        assert not list((cache_dir / "autotune").glob("*.tmp"))

    def test_card_keyed(self, cache_dir):
        autotune.record(autotune.INT8_KERNEL, autotune.int8_key(*HEAD, card=OTHER),
                        {"branch": "tiled"})
        # a winner timed on another GPU model never steers this one
        assert autotune.cached_int8_geometry(*HEAD, H100) is None
        assert K.int8_matmul_geometry(*HEAD, H100) == ("splitk", 160, (8, 16))
        assert K.int8_matmul_geometry(*HEAD, OTHER) == K.tiled_geometry(*HEAD)

    def test_disabled_without_cache_dir(self, monkeypatch):
        monkeypatch.delenv("NNSTPU_COMPILE_CACHE_DIR", raising=False)
        assert not autotune.enabled()
        assert autotune.cached_int8_geometry(*HEAD, H100) is None
        assert not autotune.record(autotune.INT8_KERNEL, "k", {})

    def test_switched_off_by_conf(self, cache_dir, monkeypatch):
        autotune.record(autotune.INT8_KERNEL, autotune.int8_key(*HEAD, card=H100),
                        {"branch": "tiled"})
        monkeypatch.setenv("NNSTPU_COMPILE_AUTOTUNE", "false")
        autotune.refresh()
        assert K.int8_matmul_geometry(*HEAD, H100) == ("splitk", 160, (8, 16))

    def test_corrupt_table_falls_back(self, cache_dir):
        path = cache_dir / "autotune" / f"{autotune.INT8_KERNEL}.json"
        os.makedirs(path.parent, exist_ok=True)
        path.write_text("{broken json")
        assert autotune.cached_int8_geometry(*HEAD, H100) is None
        key = autotune.int8_key(*HEAD, card=H100)
        assert autotune.record(autotune.INT8_KERNEL, key, {"branch": "tiled"})  # rewritten whole
        autotune.refresh()
        assert autotune.best(autotune.INT8_KERNEL, key) is not None

    @pytest.mark.parametrize("entry", [{"branch": "splitk", "split": 3},
                                       {"branch": "splitk", "split": "x"},
                                       {"branch": "tensor_core"}, {}])
    def test_entry_the_kernel_cannot_launch_is_ignored(self, cache_dir, entry):
        autotune.record(autotune.INT8_KERNEL, autotune.int8_key(*HEAD, card=H100), entry)
        assert K.int8_matmul_geometry(*HEAD, H100) == ("splitk", 160, (8, 16))


class TestConsult:
    def test_default_geometry_with_no_cache(self, monkeypatch):
        """No cache dir: the static geometry, at the path and batch shapes."""
        monkeypatch.delenv("NNSTPU_COMPILE_CACHE_DIR", raising=False)
        assert K.int8_matmul_geometry(*HEAD, H100) == ("splitk", 160, (8, 16))
        assert K.int8_matmul_geometry(*BATCH, H100) == ("tiled", 0, (32, 1))
        assert K.int8_matmul_geometry(*HEAD) == K.int8_matmul_geometry(*HEAD, H100)

    def test_consult_reads_once_then_refresh(self, cache_dir):
        """The first lookup of a shape reads the file; later ones do not,
        until refresh()."""
        key = autotune.int8_key(*BATCH, card=H100)
        autotune.record(autotune.INT8_KERNEL, key, {"branch": "splitk", "split": 8})
        autotune.refresh()
        tuned = K.int8_matmul_geometry(*BATCH, H100)
        assert tuned == ("splitk", 160, (8, 16, 2))
        (cache_dir / "autotune" / "int8_matmul.json").unlink()
        assert K.int8_matmul_geometry(*BATCH, H100) == tuned  # no file I/O a call
        autotune.refresh()
        assert K.int8_matmul_geometry(*BATCH, H100) == ("tiled", 0, (32, 1))

    def test_record_in_this_process_is_consulted(self, cache_dir):
        assert K.int8_matmul_geometry(*HEAD, H100) == ("splitk", 160, (8, 16))
        autotune.record(autotune.INT8_KERNEL, autotune.int8_key(*HEAD, card=H100),
                        {"branch": "splitk", "split": 2})
        assert K.int8_matmul_geometry(*HEAD, H100) == ("splitk", 640, (2, 16))

    def test_cpu_call_stays_plain(self, cache_dir, monkeypatch):
        """On CPU tensors the wrapper runs the plain version and consults
        nothing (the card's name is never asked)."""
        autotune.record(autotune.INT8_KERNEL, autotune.int8_key(*HEAD, card=H100),
                        {"branch": "tiled"})
        monkeypatch.setattr(K, "_card_name", lambda dev: pytest.fail("consulted on the CPU"))
        xq, wq, xs, ws, b = _operands(*HEAD, seed=1)
        got = K.int8_matmul(xq, wq, xs, ws, b)
        assert torch.equal(got, K.int8_matmul_plain(xq, wq, xs, ws, b))


class TestSearch:
    def test_autotune_refuses_a_cpu_device(self):
        with pytest.raises(RuntimeError, match="refuses cpu"):
            autotune.autotune_int8_matmul(*HEAD, device="cpu")

    @pytest.mark.parametrize("shape", [HEAD, BATCH])
    def test_candidates_are_what_the_kernel_launches(self, shape):
        m, k, n = shape
        cands = autotune.int8_candidates(m, k, n)
        assert cands == [{"branch": "splitk", "split": s} for s in (1, 2, 4, 8)] + [
            {"branch": "tiled"}]
        for c in cands:
            geo = autotune.geometry_of(c, m, k, n)
            if geo.branch == "splitk":
                split = geo.grid[0]
                assert geo.k_per_rank % 4 == 0 and geo.k_per_rank * split >= k
                assert (geo.k_per_rank - 4) * split < k
                chunks = geo.grid[2] if len(geo.grid) == 3 else 1
                assert chunks == -(-m // K.SMALL_M)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    xs = torch.tensor(np.float32(rng.random() * 0.02 + 1e-3))
    ws = torch.from_numpy((rng.random(n) * 0.01 + 1e-4).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return xq, wq, xs, ws, b


def _emulate(geo, xq, wq, xs, ws, b):
    """The kernel's partition of the work at ``geo``, in numpy: per chunk of
    rows and cluster rank, the int32 sums of its K range, added rank by
    rank, then the float32 epilogue ``acc * (xs * ws) + b`` one rounding an
    operation."""
    x = xq.numpy().astype(np.int32)
    w = wq.numpy().astype(np.int32)
    m, k = x.shape
    if geo.branch == "tiled":
        acc = x @ w
    else:
        split = geo.grid[0]
        acc = np.zeros((m, w.shape[1]), np.int32)
        for m0 in range(0, m, K.SMALL_M):
            rows = slice(m0, min(m, m0 + K.SMALL_M))
            for rank in range(split):
                lo, hi = rank * geo.k_per_rank, min(k, (rank + 1) * geo.k_per_rank)
                acc[rows] += x[rows, lo:hi] @ w[lo:hi]
    scale = np.float32(xs.numpy()) * ws.numpy().reshape(1, -1)
    return acc.astype(np.float32) * scale + b.numpy().reshape(1, -1)


@pytest.mark.parametrize("shape", [HEAD, BATCH, (17, 300, 70), (3, 1283, 65)])
def test_every_candidate_partition_is_bitwise_the_plain_version(shape):
    m, k, n = shape
    xq, wq, xs, ws, b = _operands(m, k, n, seed=m * 31 + n)
    plain = K.int8_matmul_plain(xq, wq, xs, ws, b).numpy()
    for c in autotune.int8_candidates(m, k, n):
        got = _emulate(autotune.geometry_of(c, m, k, n), xq, wq, xs, ws, b)
        np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32), err_msg=str(c))
    want = np.asarray(jk.int8_matmul(jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()),
                                     float(xs), jnp.asarray(ws.numpy().reshape(1, -1)),
                                     jnp.asarray(b.numpy())))
    acc = (xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64)).astype(np.float32)
    prod = acc * (np.float32(xs.numpy()) * ws.numpy())
    tol = np.spacing(np.abs(prod)) + np.spacing(np.abs(plain))
    assert np.all(np.abs(plain - want) <= tol)

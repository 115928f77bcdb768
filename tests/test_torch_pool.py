"""The port's ``BufferPool`` and ``fence`` against the JAX package's
``pool.py``, after ``tests/test_pool.py``.

Each scenario runs on both pools through one function (a lease is a numpy
``PooledArray`` there and a torch tensor here) and the two ``stats()``
dicts must be equal after it: hits, misses, recycles, evictions, leased
and free bytes, free buffers and classes.  The fence is a CUDA event in
the port: on the CPU a fake event stands in for it (its ``synchronize``
counted, as the reference's tests count ``block_until_ready``), and the
``cuda`` case holds a real copy's event on the card.
"""

import gc

import numpy as np
import pytest
import torch

from nnstreamer_tpu import pool as jpool
from nnstreamer_tpu_torch import pool as tpool


class FakeEvent:
    """A copy's completion: ``synchronize`` (the port's event) and
    ``block_until_ready`` (the reference's device array), counted."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1

    block_until_ready = synchronize


JAX = dict(mod=jpool, dt=np.float32, ptr=lambda a: a.ctypes.data,
           views=lambda a: (np.asarray(a)[0], np.asarray(a).reshape(-1)))
PORT = dict(mod=tpool, dt=torch.float32, ptr=lambda a: a.data_ptr(),
            views=lambda a: (a[0], a.reshape(-1)))


def _both(scenario):
    out = [scenario(pkg) for pkg in (PORT, JAX)]
    assert out[0] == out[1]
    return out[0]


def test_miss_then_hit_reuses_memory():
    def run(pkg):
        pool = pkg["mod"].BufferPool(max_per_class=4, max_bytes=1 << 20)
        a = pool.lease((8,), pkg["dt"])
        fresh, ptr = a.pool_fresh, pkg["ptr"](a)
        pool.recycle(a)
        del a
        b = pool.lease((8,), pkg["dt"])
        return fresh, b.pool_fresh, pkg["ptr"](b) == ptr, pool.stats()

    assert _both(run)[:3] == (True, False, True)


def test_distinct_classes_never_cross():
    def run(pkg):
        pool = pkg["mod"].BufferPool(max_per_class=4, max_bytes=1 << 20)
        a = pool.lease((8,), pkg["dt"])
        pool.recycle(a)
        del a
        other = torch.int32 if pkg is PORT else np.int32
        return (pool.lease((8,), other).pool_fresh, pool.lease((4, 2), pkg["dt"]).pool_fresh,
                pool.stats())

    assert _both(run)[:2] == (True, True)


def test_pinned_and_pageable_are_distinct_classes():
    """The port keys a class by page-locking too: a lease for the card
    never recycles into one for the host.  (Pinning needs CUDA; without
    it the key alone is checked.)"""
    pool = tpool.BufferPool(max_per_class=4, max_bytes=1 << 20)
    assert pool._key((8,), torch.uint8, True) != pool._key((8,), torch.uint8, False)
    a = pool.lease((8,), torch.uint8)
    pool.recycle(a)
    del a
    assert pool.stats()["free_buffers"] == 1
    if torch.cuda.is_available():
        assert pool.lease((8,), torch.uint8, pin=True).pool_fresh


def test_auto_recycle_when_the_last_view_drops():
    """Two branches hold views of one lease (a tee): it stays leased until
    both have dropped them, then returns without an explicit recycle."""
    def run(pkg):
        pool = pkg["mod"].BufferPool(max_per_class=4, max_bytes=1 << 20)
        a = pool.lease((4, 8), pkg["dt"])
        a[:] = 7.0
        v1, v2 = pkg["views"](a)
        del a
        states = [pool.stats()["recycles"]]
        del v1
        gc.collect()
        states.append(pool.stats()["recycles"])
        assert float(v2[31]) == 7.0
        del v2
        gc.collect()
        return states, pool.stats()

    states, st = _both(run)
    assert states == [0, 0] and st["recycles"] == 1 and st["leased_bytes"] == 0


def test_explicit_recycle_is_idempotent():
    def run(pkg):
        pool = pkg["mod"].BufferPool(max_per_class=4, max_bytes=1 << 20)
        a = pool.lease((8,), pkg["dt"])
        pool.recycle(a)
        pool.recycle(a)
        del a
        return pool.stats()

    assert _both(run)["recycles"] == 1


def test_per_class_overflow_counts_an_eviction():
    def run(pkg):
        pool = pkg["mod"].BufferPool(max_per_class=1, max_bytes=1 << 20)
        a, b = pool.lease((8,), pkg["dt"]), pool.lease((8,), pkg["dt"])
        pool.recycle(a)
        pool.recycle(b)
        del a, b
        return pool.stats()

    st = _both(run)
    assert st["evictions"] == 1 and st["free_buffers"] == 1 and st["free_bytes"] == 32


def test_byte_bound_evicts_the_oldest_first():
    """A renegotiated stream's old size class drains out, oldest first."""
    def run(pkg):
        pool = pkg["mod"].BufferPool(max_per_class=8, max_bytes=96)
        old = [pool.lease((8,), pkg["dt"]) for _ in range(2)]
        for x in old:
            pool.recycle(x)
        del old
        new = pool.lease((16,), pkg["dt"])
        pool.recycle(new)
        del new
        return pool.stats()

    st = _both(run)
    assert st["evictions"] == 1 and st["free_bytes"] == 96 and st["classes"] == 2


def test_oversize_buffer_never_pooled():
    def run(pkg):
        pool = pkg["mod"].BufferPool(max_per_class=4, max_bytes=16)
        a = pool.lease((64,), pkg["dt"])
        pool.recycle(a)
        del a
        return pool.stats()

    st = _both(run)
    assert st["evictions"] == 1 and st["free_bytes"] == 0


def test_disabled_by_conf_always_fresh(monkeypatch):
    monkeypatch.setenv("NNSTPU_POOL_ENABLED", "false")

    def run(pkg):
        pool = pkg["mod"].BufferPool()
        a = pool.lease((8,), pkg["dt"])
        pool.recycle(a)
        del a
        return pool.lease((8,), pkg["dt"]).pool_fresh, pool.stats()

    fresh, st = _both(run)
    assert fresh and st["free_buffers"] == 0


def test_fence_gates_the_next_lease_not_the_recycle():
    def run(pkg):
        pool = pkg["mod"].BufferPool(max_per_class=4, max_bytes=1 << 20)
        a = pool.lease((4, 2), pkg["dt"])
        event = FakeEvent()
        assert pkg["mod"].fence(a, event) is True
        pool.recycle(a)
        del a
        waits = [event.waits]
        b = pool.lease((4, 2), pkg["dt"])
        return waits + [event.waits], b.pool_fresh

    assert _both(run) == ([0, 1], False)


def test_fence_is_a_no_op_off_the_pool_and_on_a_fresh_lease():
    assert tpool.fence(torch.zeros(4), FakeEvent()) is False
    assert jpool.fence(np.zeros(4), FakeEvent()) is False
    pool = tpool.BufferPool(max_per_class=4, max_bytes=1 << 20)
    a = pool.lease((8,), torch.float32)
    assert tpool.fence(a, None) is False  # a CPU copy: no event
    assert tpool.fence(a[2:], FakeEvent()) is False  # a view carries no pool
    event = FakeEvent()
    tpool.fence(a, event)
    assert pool.lease((8,), torch.float32).pool_fresh and event.waits == 0


def test_default_pool_is_the_ports_own():
    tpool.reset_default_pool()
    p = tpool.default_pool()
    assert p is tpool.default_pool() and p is not jpool.default_pool()
    tpool.reset_default_pool()
    assert tpool.default_pool() is not p


@pytest.mark.cuda
def test_cuda_fence_holds_a_lease_until_its_copy_is_done():
    """A pinned lease copied to the card on a stream held back by
    ``torch.cuda._sleep``: the next lease of its class waits for the
    copy's event, so rewriting it cannot reach the copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pool = tpool.BufferPool(max_per_class=2, max_bytes=1 << 30)
    a = pool.lease((4096, 4096), torch.uint8, pin=True)
    a.fill_(7)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)
        d = a.to("cuda", non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    assert tpool.fence(a, event)
    pool.recycle(a)
    del a
    b = pool.lease((4096, 4096), torch.uint8, pin=True)
    assert not b.pool_fresh and event.query()  # the lease waited
    b.fill_(9)
    torch.cuda.synchronize()
    assert int(d.min()) == int(d.max()) == 7

"""Consumers of an uploaded frame wait for its copy.

``tensor_upload`` issues each host→device copy on a side stream and sends
the device tensor on with the copy's event (``pool.mark_ready``).  Every
node's dispatch of a frame into ``process`` makes the current stream wait
for that event first (``graph/node.py``), so a sink, a decoder or an
aggregator fed straight by the upload reads the frame only after the copy,
and the filter's backend adds no second wait.  The queue's dispatch only
enqueues, and does not wait.

The CPU tests count the waits; the ``cuda``-marked tests show the fault
itself on the card: the upload's stream is held back before each copy, and
a ``new-data`` callback reads the frame (a 32 MiB frame at the sink, or the
aggregator's window of three 8 MiB frames) with ``.cpu()``.
This file imports no JAX, so the GPU test runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_upload_wait.py``.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch import pool
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.elements.upload import TensorUpload
from nnstreamer_tpu_torch.graph import node as node_mod

HOLD_CYCLES = 200_000_000  # about 0.1 s of the card's clock before each copy


@pytest.fixture
def waits(monkeypatch):
    """Every wait a dispatch makes, as (node name, tensor id)."""
    seen = []
    real = pool.wait_ready

    def counting(t):
        seen.append((current[0], id(t)))
        return real(t)

    current = [None]
    real_dispatch = node_mod.Node._dispatch

    def dispatch(self, pad, item):
        current[0] = self.name
        return real_dispatch(self, pad, item)

    monkeypatch.setattr(node_mod, "wait_ready", counting)
    monkeypatch.setattr(pool, "wait_ready", counting)
    monkeypatch.setattr(node_mod.Node, "_dispatch", dispatch)
    # no card here: the upload sends its frames on as host tensors
    monkeypatch.setattr(TensorUpload, "_target_device", lambda self: torch.device("cpu"))
    return seen


@pytest.mark.parametrize("consumer", [
    "tensor_sink name=out",
    "tensor_aggregator name=agg frames-out=2 frames-dim=1 ! fakesink name=out",
    "tensor_filter framework=torch name=f ! fakesink name=out",
])
def test_each_consumer_waits_once_per_tensor(waits, consumer):
    p = tnns.parse_launch(f"datasrc name=s ! tensor_upload name=u ! queue ! {consumer}")
    p["s"].data = [torch.full((4, 2), i, dtype=torch.float32) for i in range(4)]
    if "f" in p.nodes:
        p["f"].model = TorchModel(apply=lambda params, x: x + 1, device="cpu")
    p.run(timeout=60)
    first = consumer.split("name=")[1].split()[0]
    by_node = {}
    for name, _ in waits:
        by_node[name] = by_node.get(name, 0) + 1
    assert by_node.get(first) == 4          # each frame's one tensor, once
    assert "queue0" not in by_node and not any(n.startswith("queue") for n in by_node)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_sink_callback_reads_uploaded_frame_after_its_copy(cuda_device):
    del cuda_device
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, 32 << 20, dtype=np.uint8) for _ in range(4)]
    p = tnns.parse_launch(
        "datasrc name=s ! tensor_converter input-dim=8192:4096 input-type=uint8 ! "
        "tensor_upload name=u ! queue ! tensor_sink name=out")
    p["s"].data = [torch.from_numpy(f) for f in frames]
    seen = []
    p["out"].connect("new-data", lambda fr: seen.append(fr.tensor(0).cpu().numpy()))
    u = p["u"]
    upload = u.process

    def held_upload(pad, frame):
        with torch.cuda.stream(u._stream):
            torch.cuda._sleep(HOLD_CYCLES)
        return upload(pad, frame)

    u.process = held_upload
    p.run(timeout=120)
    assert len(seen) == len(frames)
    bad = [i for i, (got, want) in enumerate(zip(seen, frames))
           if not np.array_equal(got.reshape(-1), want)]
    assert not bad, f"frames {bad} read before their upload's copy completed"


@pytest.mark.cuda
def test_cuda_aggregator_windows_uploaded_frames_after_their_copy(cuda_device):
    """The aggregator joins frames already on the card; fed straight by the
    upload, it reads each after its copy."""
    rng = np.random.default_rng(1)
    blocks = [rng.integers(-32768, 32768, (1 << 20, 4)).astype(np.int16) for _ in range(6)]
    p = tnns.parse_launch("datasrc name=s ! tensor_upload name=u ! queue ! "
                          "tensor_aggregator frames-out=3 frames-dim=1 ! tensor_sink name=out")
    p["s"].data = [torch.from_numpy(b) for b in blocks]
    seen = []
    p["out"].connect("new-data", lambda fr: seen.append(
        (fr.tensor(0).device.type, fr.tensor(0).cpu().numpy())))
    u = p["u"]
    upload = u.process

    def held_upload(pad, frame):
        with torch.cuda.stream(u._stream):
            torch.cuda._sleep(HOLD_CYCLES)
        return upload(pad, frame)

    u.process = held_upload
    p.run(timeout=120)
    assert [d for d, _ in seen] == ["cuda", "cuda"]
    for i, (_, got) in enumerate(seen):
        np.testing.assert_array_equal(got, np.concatenate(blocks[3 * i:3 * i + 3]))

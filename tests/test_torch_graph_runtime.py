"""The port's graph runtime against the JAX package's, on the CPU.

``parse_launch`` builds the same graphs from the same strings; the frame
queue's leak modes and backpressure deliver the same sequences; the upload
element leaves outputs as they were; transform fusion and the segment
planner hop over ``tensor_upload ! queue`` alike; and the image-labeling
slice (MobileNet-v2 width 0.35, 64x64, 10 classes, 8 frames, the JAX
model's own params) runs through the canonical launch string in both
packages with the tolerances of ``tests/test_torch_pipeline.py``: labels,
label indices, the decoder's output tensor and timestamps equal, the top
score within 0.15 (the bf16 trunk rounds differently in the two
frameworks).  The port runs on ``device="cpu"``; its staging and residency
helpers are checked here too.
"""

import re
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.graph import optimize as joptimize
from nnstreamer_tpu.graph import segments as jsegments
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.native import queue as jqueue
from nnstreamer_tpu_torch import pool
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.queue import Queue
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.elements.upload import TensorUpload
from nnstreamer_tpu_torch.graph import optimize as toptimize
from nnstreamer_tpu_torch.graph import residency
from nnstreamer_tpu_torch.graph import segments as tsegments
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.native import queue as tqueue
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec

from conftest import cpu_subprocess_env

REPO = Path(__file__).resolve().parents[1]
NORMALIZE = "typecast:float32,add:-127.5,div:127.5"
SIZE, CLASSES, FRAMES = 64, 10, 8

# The canonical image-labeling topology, as the JAX package spells it.
CANONICAL = (
    "videotestsrc num-buffers={n} width={size} height={size} pattern=random seed=3 ! "
    "tensor_converter ! "
    "tensor_transform mode=arithmetic option=" + NORMALIZE + " acceleration=pallas ! "
    "tensor_upload ! queue max-size-buffers=16 ! "
    "tensor_filter framework=jax name=f ! "
    "tensor_decoder mode=image_labeling option1={labels} ! tensor_sink name=out collect=true"
)


def port_string(desc: str) -> str:
    """The same launch string for the port on the CPU: its transforms take
    ``device=cpu`` and its filters ``framework=torch``."""
    desc = desc.replace("framework=jax", "framework=torch")
    return re.sub(r"(tensor_transform)(\s)", r"\1 device=cpu\2", desc)


# -- parse_launch -------------------------------------------------------------

LAUNCH_STRINGS = [
    # from the JAX package's tests (only elements the port has)
    "videotestsrc num-buffers=3 width=32 height=32 ! tensor_converter ! "
    "tensor_sink name=out collect=true",
    "videotestsrc num-buffers=2 width=20 height=10 ! tensor_converter ! "
    "tensor_sink name=out collect=true",
    "videotestsrc num-buffers=3 width=8 height=8 framerate=50/1 ! tensor_converter ! "
    "tensor_sink name=out collect=true",
    "videotestsrc num-buffers=1 ! tensor_sink name=out",
    "datasrc name=s ! tensor_upload ! queue ! tensor_filter framework=jax name=f ! "
    "tensor_sink name=out",
    CANONICAL.format(n=64, size=224, labels=""),
    # pad references, auto names, quoting, dashes
    "videotestsrc num-buffers=2 name=v ! queue name=q max-size-buffers=4 leaky=downstream "
    "q. ! tensor_sink name=out",
    "tensor_sink name=out videotestsrc num-buffers=1 ! queue ! out.",
    "tensor_sink name=out videotestsrc num-buffers=1 ! out.sink",
    "videotestsrc ! queue ! queue ! queue leaky=upstream ! tensor_sink",
    "videotestsrc ! tensor_converter frames-per-tensor=2 ! "
    "tensor_transform mode=arithmetic option='typecast:float32, mul:2' ! tensor_sink",
    "videotestsrc pattern=smpte ! tensor_converter ! tensor_transform mode=typecast "
    "option=float32 acceleration=false ! tensor_decoder mode=image_labeling ! tensor_sink",
]

_PROPS = ("num_buffers", "pattern", "seed", "max_size", "leaky", "collect", "mode",
          "option", "acceleration", "frames_per_tensor", "custom", "framework")


def _graph(p, jax_side: bool):
    """Nodes (type, properties) and links; automatic names (a global
    counter in each package) become the type and the node's position."""
    canon = {name: re.sub(r"\d+$", "", name) + f"#{i}" for i, name in enumerate(p.nodes)}
    nodes = {}
    for name, n in p.nodes.items():
        props = {k: getattr(n, k) for k in _PROPS if hasattr(n, k)}
        if "framework" in props and not jax_side:
            props["framework"] = props["framework"].replace("torch", "jax")
        video = getattr(n, "video", None)
        if video is not None:
            props["video"] = (video.width, video.height, video.rate)
        nodes[canon[name]] = (type(n).__name__, props)
    links = sorted((canon[n.name], pad.name, canon[pad.peer.node.name], pad.peer.name)
                   for n in p.nodes.values() for pad in n.src_pads.values()
                   if pad.peer is not None)
    return nodes, links


@pytest.mark.parametrize("desc", LAUNCH_STRINGS)
def test_parse_launch_builds_the_same_graph(desc):
    want = _graph(jnns.parse_launch(desc), True)
    got = _graph(tnns.parse_launch(port_string(desc)), False)
    assert got == want


@pytest.mark.parametrize("desc", [
    "! tensor_sink",
    "videotestsrc !",
    "videotestsrc name=a ! tensor_sink name=a",
    "videotestsrc bogus=1 ! tensor_sink",
])
def test_parse_errors_match(desc):
    with pytest.raises(jnns.graph.parse.ParseError) as want:
        jnns.parse_launch(desc)
    with pytest.raises(tnns.ParseError) as got:
        tnns.parse_launch(desc)
    # same kind of complaint: the first word of the message
    assert str(got.value).split()[0] == str(want.value).split()[0]


@pytest.mark.parametrize("desc", [
    "videotestsrc name='a ! tensor_sink",  # no closing quotation
    "videotestsrc ! nosuch.",  # a pad reference to no element
    "name=x ! tensor_sink",  # a property with no element
    "videotestsrc num-buffers ! tensor_sink",  # a bare word
    "tensor_sink name=out videotestsrc ! out.bogus",  # no such pad
    "videotestsrc ! tensor_sink name=out out. ! tensor_sink",  # a sink has no src pad
    "videotestsrc ! queue leaky=sideways ! tensor_sink",
    "videotestsrc ! queue max-size-buffers=abc ! tensor_sink",
])
def test_bad_strings_raise_the_same_error(desc):
    """The same complaint from both packages, up to the list of known
    elements (which differs: the port has fewer)."""
    with pytest.raises(ValueError) as want:
        jnns.parse_launch(desc)
    with pytest.raises(ValueError) as got:
        tnns.parse_launch(desc)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


def test_unknown_element_raises_in_both():
    with pytest.raises(ValueError, match="unknown element"):
        jnns.parse_launch("nosuchelement ! tensor_sink")
    with pytest.raises(ValueError, match="unknown element"):
        tnns.parse_launch("nosuchelement ! tensor_sink")


@pytest.mark.parametrize("desc,cut", [
    ("videotestsrc ! tensor_converter ! tensor_transform mode=typecast option=float32 ! "
     "tensor_sink name=out", 1),
    ("videotestsrc ! tensor_converter ! tensor_transform mode=typecast option=float32 ! "
     "tensor_sink name=out", 2),
])
def test_linear_chain_and_split_launch_match(desc, cut):
    from nnstreamer_tpu.graph import parse as jparse
    from nnstreamer_tpu_torch.graph import parse as tparse

    assert tparse.linear_chain(desc) == jparse.linear_chain(desc)
    props = {"host": "localhost", "port": "5001"}
    assert tparse.split_launch(desc, cut, props) == jparse.split_launch(desc, cut, props)
    for bad in ("a ! b. ! c", "a ! b c ! d"):
        with pytest.raises(tparse.ParseError):
            tparse.linear_chain(bad)


def test_get_by_name_and_getitem():
    p = tnns.parse_launch("videotestsrc name=v ! tensor_sink name=out")
    assert p.get_by_name("v") is p["v"] is p.nodes["v"]


# -- the frame queue ----------------------------------------------------------


def _frames(nns, conv, n, seed):
    rng = np.random.default_rng(seed)
    return [nns.Frame.of(conv(rng.integers(0, 256, (2, 3)).astype(np.uint8)), pts=i)
            for i in range(n)]


def _drain(q):
    out = []
    while True:
        status, item = q.pop(0)
        if status != 0:
            return out
        out.append(item)


def _seq(items):
    """Frames as (pts, bytes), events as their kind."""
    return [it.kind if not hasattr(it, "tensors") else
            (it.pts, np.asarray(it.tensors[0]).tobytes()) for it in items]


# (op, arg): push frame i, push an event, or pop one item.  Every push
# has a zero timeout, so a full queue that may not leak answers TIMEOUT.
QUEUE_SCRIPT = [("frame", 0), ("event", "flush"), ("frame", 1), ("frame", 2), ("pop", None),
                ("frame", 3), ("event", "caps"), ("frame", 4), ("frame", 5), ("pop", None),
                ("frame", 6), ("event", "eos")]


@pytest.mark.parametrize("leaky", ["no", "downstream", "upstream"])
@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_frame_queue_leak_modes_match(leaky, capacity):
    """One script of pushes and pops on a queue of each package: the same
    statuses, the same frames out in the same order, the same drop count,
    and no event dropped."""
    runs = []
    for nns, qmod, conv in ((jnns, jqueue, np.asarray), (tnns, tqueue, torch.from_numpy)):
        q = qmod.PyFrameQueue(capacity)
        frames = _frames(nns, conv, 7, seed=5)
        statuses, popped = [], []
        for op, arg in QUEUE_SCRIPT:
            if op == "pop":
                popped.append(q.pop(0)[1])
            else:
                item = frames[arg] if op == "frame" else nns.Event(arg)
                statuses.append(q.push(item, leaky=leaky, timeout_ms=0))
        runs.append((statuses, _seq(popped + _drain(q)), q.stats()))
    assert runs[0] == runs[1]
    statuses, out, _ = runs[1]
    pushes = [o for o in QUEUE_SCRIPT if o[0] != "pop"]
    accepted = [arg for (op, arg), st in zip(pushes, statuses) if op == "event" and st == 0]
    assert [x for x in out if isinstance(x, str)] == accepted  # accepted events all arrive


def test_frame_queue_backpressure_blocks_until_popped():
    for qmod in (jqueue, tqueue):
        q = qmod.PyFrameQueue(1)
        assert q.push("a") == 0
        assert q.push("b", timeout_ms=20) == -2  # full: TIMEOUT
        got = []

        def producer():
            got.append(q.push("c"))  # blocks until the consumer pops

        t = threading.Thread(target=producer)
        t.start()
        time.sleep(0.05)
        assert got == []
        assert q.pop(1000) == (0, "a")
        t.join(5)
        assert got == [0]
        assert q.pop(1000) == (0, "c")
        q.shutdown()
        assert q.pop(10) == (-1, None)
        assert q.push("d") == -1


@pytest.mark.parametrize("max_size", [1, 2, 16])
def test_queue_element_delivers_every_frame_in_order(max_size):
    """datasrc → queue (backpressure) → sink: all frames, in order, in both
    packages."""
    data = [np.random.default_rng(i).integers(0, 256, (3, 4)).astype(np.uint8)
            for i in range(12)]
    outs = []
    for nns, conv in ((jnns, np.asarray), (tnns, torch.from_numpy)):
        p = nns.parse_launch(f"datasrc name=s ! queue max-size-buffers={max_size} ! "
                             "tensor_sink name=out collect=true")
        p["s"].data = [conv(d) for d in data]
        p.run(timeout=60)
        outs.append([(f.pts, np.asarray(f.tensor(0)).tobytes()) for f in p["out"].frames])
    assert outs[0] == outs[1]
    assert len(outs[1]) == 12


def test_queue_stats_and_stop_join_threads():
    p = tnns.parse_launch("videotestsrc num-buffers=5 width=4 height=4 ! "
                          "queue name=q max-size-buffers=3 ! tensor_sink name=out")
    p.start()
    assert any(t.name == "queue:q" for t in p.threads)
    assert p.wait(30)
    stats = p["q"].stats()
    assert stats["capacity"] == 3 and stats["dropped"] == 0 and stats["leaky"] == "no"
    p.stop()
    assert p.threads == []
    assert p["out"].num_frames == 5


def test_queue_interrupt_releases_a_blocked_producer():
    q = Queue(max_size_buffers=1)
    q._dispatch(None, tnns.Frame.of(torch.zeros(1)))
    t = threading.Thread(target=q._dispatch, args=(None, tnns.Frame.of(torch.ones(1))))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()  # blocked on the full queue
    q.interrupt()
    t.join(5)
    assert not t.is_alive()
    q.stop()


def test_queue_rejects_unknown_leak_mode():
    with pytest.raises(ValueError, match="leaky"):
        Queue(leaky="sideways")


# -- tensor_upload on the CPU -------------------------------------------------


def _affine_model():
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 5)).astype(np.float32))
    return TorchModel(apply=lambda params, x: x.reshape(-1, 6) @ params, params=w,
                      device="cpu",
                      input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(4, 6))))


def test_upload_outputs_equal_without_it():
    data = [np.random.default_rng(i).standard_normal((4, 6)).astype(np.float32)
            for i in range(5)]
    outs = []
    for chain in ("datasrc name=s ! tensor_filter framework=torch name=f ! "
                  "tensor_sink name=out collect=true",
                  "datasrc name=s ! tensor_upload ! queue ! tensor_filter framework=torch "
                  "name=f ! tensor_sink name=out collect=true"):
        p = tnns.parse_launch(chain)
        p["s"].data = [torch.from_numpy(d) for d in data]
        p["f"].model = _affine_model()
        p.run(timeout=60)
        outs.append([f.tensor(0) for f in p["out"].frames])
    assert len(outs[0]) == len(outs[1]) == 5
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_upload_targets_the_filter_device():
    p = tnns.parse_launch("datasrc name=s ! tensor_upload name=u ! queue ! "
                          "tensor_filter framework=torch name=f ! tensor_sink")
    p["s"].data = [np.zeros((4, 6), np.float32)]
    p["f"].model = _affine_model()
    p.run(timeout=60)
    assert p["u"].device == torch.device("cpu")


def test_upload_without_a_filter_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tnns.parse_launch("datasrc name=s ! tensor_upload ! tensor_sink")
    p["s"].data = [np.zeros((2,), np.float32)]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        p.run(timeout=30)


# -- fusion and segments across upload and queue ------------------------------


def _hop_graph(nns):
    p = nns.parse_launch(
        "videotestsrc name=v num-buffers=2 width=8 height=8 ! tensor_converter name=c ! "
        "tensor_transform name=t mode=arithmetic option=typecast:float32,div:255.0 "
        "acceleration=pallas" + (" device=cpu" if nns is tnns else "") + " ! "
        "tensor_upload name=u ! queue name=q ! tensor_filter framework="
        + ("torch" if nns is tnns else "jax") + " name=f ! "
        "tensor_decoder name=d mode=image_labeling ! tensor_sink name=out")
    return p


def test_fusion_and_segment_plans_hop_upload_and_queue():
    plans = []
    for nns, opt, seg in ((jnns, joptimize, jsegments), (tnns, toptimize, tsegments)):
        p = _hop_graph(nns)
        opt.fuse_transforms(p)
        assert "t" not in p.nodes, "the transform did not fold across upload and queue"
        assert [tr.name for tr in p["f"]._fused_pre] == ["t"]
        # the upload now reads the converter's raw frames
        assert p["u"].sink_pads["sink"].peer.node.name == "c"
        plans.append([(pl.filter, pl.pre, pl.post, pl.cuts, pl.fallbacks, pl.label)
                      for pl in seg.plan_segments(p)])
    assert plans[0] == plans[1]
    assert plans[1][0][-1] == "c+f+d"


def test_fusion_hops_over_upload_and_queue():
    """transform → upload → queue → filter runs folded, and equals the
    unfolded chain."""
    frames = [np.random.default_rng(i).integers(0, 255, (4, 6)).astype(np.uint8)
              for i in range(4)]
    outs = []
    for fuse in (True, False):
        p = tnns.parse_launch(
            "datasrc name=s ! tensor_transform name=t mode=arithmetic "
            "option=typecast:float32,div:255.0 device=cpu ! tensor_upload ! "
            "queue max-size-buffers=8 ! tensor_filter framework=torch name=f ! "
            "tensor_sink name=out collect=true")
        p.auto_fuse = fuse
        p["s"].data = [torch.from_numpy(f) for f in frames]
        p["f"].model = _affine_model()
        p.run(timeout=60)
        assert bool(p["f"]._fused_pre) == fuse
        outs.append([f.tensor(0) for f in p["out"].frames])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    want = torch.from_numpy((frames[0].astype(np.float32) / np.float32(255.0)).reshape(-1, 6))
    torch.testing.assert_close(outs[0][0], want @ _affine_model().params, rtol=1e-6, atol=1e-6)


def test_residency_walk_hops_plumbing():
    p = tnns.parse_launch("datasrc name=s ! tensor_upload name=u ! queue name=q ! "
                          "queue name=q2 ! tensor_filter framework=torch name=f ! "
                          "tensor_sink name=out")
    assert residency.downstream_filter_node(p["u"]) is p["f"]
    assert residency.downstream_backend(p["s"]) is p["f"].backend
    assert residency.downstream_backend(p["f"]) is None  # the sink has no backend
    assert residency.passthrough_types() == (Queue, TensorUpload)
    # the walk stops at an element that is not plumbing, and after 4 hops
    t = tnns.parse_launch("datasrc ! tensor_upload name=u ! tensor_transform mode=typecast "
                          "option=float32 device=cpu ! tensor_filter framework=torch ! tensor_sink")
    assert residency.downstream_filter_node(t["u"]) is None
    far = tnns.parse_launch("datasrc name=s ! " + "queue ! " * 5 +
                            "tensor_filter framework=torch ! tensor_sink")
    assert residency.downstream_filter_node(far["s"]) is None


# -- the pool on the CPU ------------------------------------------------------


class _Event:
    """Stands in for a torch.cuda.Event: counts the waits on it."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_wire_stager_ping_pong():
    st = pool.WireStager(depth=2)
    x0, x1, x2 = (torch.full((3,), float(i)) for i in range(3))
    s0 = st.stage(0, x0)
    e0 = _Event()
    st.track(0, e0)
    s1 = st.stage(0, x1)
    st.track(0, _Event())
    assert s0 is not s1 and torch.equal(s0, x0) and torch.equal(s1, x1)
    s2 = st.stage(0, x2)  # back to slot 0: waits for its copy first
    assert s2 is s0 and e0.waits == 1 and torch.equal(s2, x2)
    st.stage(1, torch.zeros(2, dtype=torch.int16))  # another tensor index
    assert not s0.is_pinned()  # the CPU path: plain tensors
    e1 = _Event()
    st.track(1, e1)
    st.reset()  # waits for the copies still reading a slot, then drops them
    assert e1.waits == 1 and not st._slots


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_wire_stager_reallocates_a_slot_for_a_new_geometry(change):
    st = pool.WireStager(depth=1)
    s0 = st.stage(0, torch.zeros(4))
    ev = _Event()
    st.track(0, ev)
    x = torch.ones(5) if change == "shape" else torch.ones(4, dtype=torch.float64)
    s1 = st.stage(0, x)
    assert ev.waits == 1  # the old slot's copy completed first
    assert s1 is not s0 and s1.shape == x.shape and s1.dtype == x.dtype and torch.equal(s1, x)


def test_wire_stager_track_without_a_stage_or_event_is_a_no_op():
    st = pool.WireStager()
    st.track(0, _Event())  # nothing staged at index 0
    s0 = st.stage(0, torch.zeros(2))
    st.track(0, None)  # the CPU path: no event
    st.stage(0, torch.zeros(2))
    assert st.stage(0, torch.ones(2)) is s0  # slot 0 again, nothing to wait on


def test_wait_ready_passes_plain_tensors():
    t = torch.ones(2)
    assert pool.wait_ready(t) is t
    assert pool.mark_ready(t, None) is t and not hasattr(t, "_nns_ready")


# -- slice 1 through the canonical launch string ------------------------------


@pytest.fixture(scope="module")
def labels_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "labels.txt"
    path.write_text("\n".join(f"class_{i}" for i in range(CLASSES)))
    return str(path)


def test_canonical_slice_matches_jax(labels_file):
    jax_model = jm.build_quantized(num_classes=CLASSES, width_mult=0.35, image_size=SIZE,
                                   int8_head=True)
    desc = CANONICAL.format(n=FRAMES, size=SIZE, labels=labels_file)
    jp = jnns.parse_launch(desc)
    jp["f"].model = jax_model
    jp.run(timeout=300)
    want = jp["out"].frames
    tp = tnns.parse_launch(port_string(desc))
    tp["f"].model = tm.build_quantized(
        num_classes=CLASSES, width_mult=0.35, image_size=SIZE, int8_head=True,
        params=jax.tree_util.tree_map(np.asarray, jax_model.params), device="cpu")
    tp.run(timeout=300)
    got = tp["out"].frames
    assert "tensor_transform0" not in tp.nodes  # folded across upload and queue
    assert len(got) == len(want) == FRAMES
    for g, w in zip(got, want):
        assert g.meta["label"] == w.meta["label"]
        assert g.meta["label_index"] == w.meta["label_index"]
        np.testing.assert_array_equal(g.tensor(0).numpy(), np.asarray(w.tensor(0)))
        assert (g.pts, g.duration) == (w.pts, w.duration)
        assert abs(g.meta["score"] - w.meta["score"]) <= 0.15


def test_canonical_string_runs_with_jax_blocked():
    desc = port_string(CANONICAL.format(n=2, size=SIZE, labels=""))
    desc = desc.replace(" option1=", "")
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "nnstreamer_tpu"):
            sys.modules[name] = None  # any import of them now raises
        import nnstreamer_tpu_torch as nns
        from nnstreamer_tpu_torch.models import mobilenet_v2
        p = nns.parse_launch({desc!r})
        p["f"].model = mobilenet_v2.build_quantized(num_classes={CLASSES}, width_mult=0.35,
                                                    image_size={SIZE}, int8_head=True,
                                                    device="cpu")
        p.run(timeout=120)
        assert not any(k == "jax" or k.startswith(("jax.", "nnstreamer_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("labels", [f.meta["label"] for f in p["out"].frames])
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=cpu_subprocess_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"labels \['\d+', '\d+'\]", out.stdout), out.stdout

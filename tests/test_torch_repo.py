"""The port's recurrence against the JAX package's: repo slots, the repo
sink and source, the LSTM cycle (BASELINE.md config 4) with the custom LSTM
filter and with ``models/lstm.build_cell``, dynamic slots, and the repo and
pipeline checkpoints, written by one package and restored by the other.

The cases mirror the reference's ``tests/test_repo.py`` and
``tests/test_save_load.py::TestCheckpoint``.  The port runs on the CPU
(``device="cpu"``).  Tolerances: the custom filters compute ``tanh`` in
numpy there and in torch here, within 2 float32 ulps of each other
(``atol=3e-7`` on values below 1); ``build_cell``'s products sum in another
order (``atol=2e-6`` over 20 steps at hidden 64).
"""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.elements import filter as jfilter, repo as jrepo, sink as jsink, \
    testsrc as jsrc
from nnstreamer_tpu.models import lstm as jlstm
from nnstreamer_tpu.utils import checkpoint as jckpt
from nnstreamer_tpu_torch.buffer import SECOND, Frame as TFrame
from nnstreamer_tpu_torch.elements import filter as tfilter, repo as trepo, sink as tsink, \
    testsrc as tsrc
from nnstreamer_tpu_torch.models import lstm as tlstm
from nnstreamer_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LSTM = os.path.join(ROOT, "examples", "custom_filters", "lstm.py")
PORT_LSTM = os.path.join(ROOT, "nnstreamer_tpu_torch", "examples", "custom_filters", "lstm.py")
PORT_RNN = os.path.join(ROOT, "nnstreamer_tpu_torch", "examples", "custom_filters", "rnn.py")
DUR = SECOND // 30
CAPS4 = ("other/tensor, dimension=(string)4:1:1:1, type=(string)float32, "
         "framerate=(fraction)0/1")


@pytest.fixture(autouse=True)
def _fresh_repos():
    jrepo.GLOBAL_REPO.reset()
    trepo.GLOBAL_REPO.reset()
    yield
    jrepo.GLOBAL_REPO.reset()
    trepo.GLOBAL_REPO.reset()


def _caps(pkg, n):
    spec = jnns.spec if pkg == "jax" else tnns.spec
    return spec.TensorsSpec(tensors=(spec.TensorSpec(dtype=np.float32, shape=(n,)),))


def _host(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _cycle(pkg, xs, framework, model, slots=(10, 11), custom=""):
    """The reference's LSTM topology: repo sources for h and c and a data
    source for x → mux (nosync) → filter → demux; h through a tee to its
    repo sink and a sink, c to its repo sink.  Returns the pipeline and the
    sink."""
    if pkg == "jax":
        nns, src, flt, snk, repo = jnns, jsrc, jfilter, jsink, jrepo
        frames = [JFrame.of(x, pts=i * DUR, duration=DUR) for i, x in enumerate(xs)]
        kw = {}
    else:
        nns, src, flt, snk, repo = tnns, tsrc, tfilter, tsink, trepo
        frames = [TFrame.of(torch.from_numpy(x), pts=i * DUR, duration=DUR)
                  for i, x in enumerate(xs)]
        kw = {"device": "cpu"}
    n = xs[0].shape[-1]
    p = nns.Pipeline(name="lstm")
    h_src = p.add(repo.TensorRepoSrc(name="h_src", slot_index=slots[0], caps=_caps(pkg, n), **kw))
    c_src = p.add(repo.TensorRepoSrc(name="c_src", slot_index=slots[1], caps=_caps(pkg, n), **kw))
    x_src = p.add(src.DataSrc(name="x_src", data=frames))
    mux = p.add(nns.make("tensor_mux", "mux", sync_mode="nosync"))
    filt = p.add(flt.TensorFilter(name="f", framework=framework, model=model, custom=custom))
    demux = p.add(nns.make("tensor_demux", "demux"))
    tee = p.add(nns.make("tee", "tee"))
    h_sink = p.add(repo.TensorRepoSink(name="h_sink", slot_index=slots[0]))
    c_sink = p.add(repo.TensorRepoSink(name="c_sink", slot_index=slots[1]))
    out = p.add(snk.TensorSink(name="out", collect=True))
    p.link(h_src, "mux.sink_0")
    p.link(c_src, "mux.sink_1")
    p.link(x_src, "mux.sink_2")
    p.link_chain(mux, filt, demux)
    p.link("demux.src_0", tee)
    p.link(tee, h_sink)
    p.link(tee, out)
    p.link("demux.src_1", c_sink)
    return p, out


def _run_cycle(*args, **kw):
    p, out = _cycle(*args, **kw)
    p.run(timeout=60)
    return [_host(f.tensor(0)) for f in out.frames], p


def _xs(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (dim,)).astype(np.float32) for _ in range(n)]


class TestRepoBasics:
    def test_slot_mailbox(self):
        assert trepo.GLOBAL_REPO.set_buffer(3, TFrame.of(torch.ones(2)), None)
        frame, _, eos = trepo.GLOBAL_REPO.get_buffer(3)
        assert not eos
        np.testing.assert_array_equal(frame.tensor(0).numpy(), [1, 1])
        frame2, _, eos2 = trepo.GLOBAL_REPO.get_buffer(3, timeout=0.05)
        assert frame2 is None and not eos2

    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_sink_to_src_pipeline_pair(self, pkg):
        """Two pipelines through one slot: the bootstrap zeros, then the data."""
        nns, src, snk, repo = (jnns, jsrc, jsink, jrepo) if pkg == "jax" else \
            (tnns, tsrc, tsink, trepo)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        data = [np.full((2,), i, np.float32) for i in range(4)]
        if pkg == "port":
            data = [torch.from_numpy(d) for d in data]
        p1 = nns.Pipeline("producer")
        p1.link(p1.add(src.DataSrc(data=data, name="d")), p1.add(repo.TensorRepoSink(slot_index=7)))
        p2 = nns.Pipeline("consumer")
        rsrc = p2.add(repo.TensorRepoSrc(slot_index=7, caps=_caps(pkg, 2), **kw))
        sink = p2.add(snk.TensorSink(collect=True))
        p2.link(rsrc, sink)
        p2.start()
        p1.run(timeout=10)
        p2.wait(timeout=10)
        p2.stop()
        got = [list(_host(f.tensor(0))) for f in sink.frames]
        assert got == [[0.0, 0.0]] + [[float(i)] * 2 for i in range(4)]

    def test_bootstrap_has_the_caps_and_the_device(self):
        rsrc = trepo.TensorRepoSrc(slot_index=1, caps=CAPS4, device="cpu")
        frame = next(iter(rsrc.frames()))
        t = frame.tensor(0)
        assert t.dtype == torch.float32 and tuple(t.shape) == (4,) and t.device.type == "cpu"
        assert not t.any() and (frame.pts, frame.duration) == (0, 0)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            trepo.TensorRepoSrc(slot_index=1, caps=CAPS4)  # the card by default

    def test_remote_repo_is_refused(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_FLEET_REPO_ADDR", "localhost:7000")
        with pytest.raises(NotImplementedError, match="repo_addr"):
            trepo.TensorRepoSink(slot_index=1)
        monkeypatch.delenv("NNSTPU_FLEET_REPO_ADDR")
        assert trepo.TensorRepoSink(slot_index=1).repo is trepo.GLOBAL_REPO

    def test_blocking_elements_are_marked(self):
        assert trepo.TensorRepoSink.LANE_BLOCKING and trepo.TensorRepoSrc.LANE_BLOCKING
        assert not tnns.Node.LANE_BLOCKING

    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_set_slot_rewires_between_runs(self, pkg):
        """``set_slot`` moves a repo sink to another slot; a source on the
        old slot then sees nothing more, one on the new slot the frames."""
        nns, src, repo = (jnns, jsrc, jrepo) if pkg == "jax" else (tnns, tsrc, trepo)
        data = [np.full((2,), i, np.float32) for i in range(2)]
        if pkg == "port":
            data = [torch.from_numpy(d) for d in data]
        p = nns.Pipeline("producer")
        rsink = p.add(repo.TensorRepoSink(slot_index=20))
        p.link(p.add(src.DataSrc(data=data[:1], name="d")), rsink)
        p.run(timeout=10)
        rsink.set_slot(21)
        p2 = nns.Pipeline("producer2")
        rsink2 = p2.add(repo.TensorRepoSink(slot_index=20))
        rsink2.set_slot(21)
        p2.link(p2.add(src.DataSrc(data=data[1:], name="d")), rsink2)
        p2.run(timeout=10)
        frame, _, _ = repo.GLOBAL_REPO.get_buffer(21, timeout=1)
        assert float(_host(frame.tensor(0))[0]) == 1.0
        assert repo.GLOBAL_REPO.get_buffer(21, timeout=0.05)[0] is None


class TestLstmCycle:
    def test_custom_python_cycle_matches_reference(self):
        """The example's LSTM filter (custom-python) in the cycle: the port's
        copy against the reference's, step by step."""
        xs = _xs(8, 4)
        got, _ = _run_cycle("port", xs, "custom-python", PORT_LSTM)
        want, _ = _run_cycle("jax", xs, "custom-python", JAX_LSTM)
        assert len(got) == len(want) == 8
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0, atol=3e-7)
        h = c = np.zeros(4, np.float32)
        for x, g in zip(xs, got):  # the example's own golden
            c = np.tanh(c + x)
            h = np.tanh(h + c)
            np.testing.assert_allclose(g, h, rtol=1e-5)

    def test_rnn_filter_matches_reference(self):
        """The example's RNN step, the port's copy against the reference's."""
        def load(path):
            spec = importlib.util.spec_from_file_location("rnn_filter", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.CustomFilter()

        rng = np.random.default_rng(4)
        h, x = (rng.uniform(-2, 2, (5,)).astype(np.float32) for _ in range(2))
        got = load(PORT_RNN).invoke(torch.from_numpy(h), torch.from_numpy(x)).numpy()
        want = load(os.path.join(ROOT, "examples", "custom_filters", "rnn.py")).invoke(h, x)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)

    def test_build_cell_cycle_matches_reference(self):
        """Config 4 at bench's width (hidden 64): ``lstm.build_cell`` on the
        reference's params in both packages, 20 steps."""
        tree = jlstm.init_params(jax.random.PRNGKey(0), 64, 64)
        xs = _xs(20, 64, seed=1)
        port = tlstm.build_cell(64, 64, params=jax.tree_util.tree_map(np.asarray, tree),
                                device="cpu")
        got, _ = _run_cycle("port", xs, "torch", port)
        want, _ = _run_cycle("jax", xs, "jax", jlstm.build_cell(64, 64, params=tree))
        assert len(got) == len(want) == 20
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0, atol=2e-6)

    def test_cell_and_sequence_match_reference(self):
        tree = jlstm.init_params(jax.random.PRNGKey(3), 8, 16)
        np_tree = jax.tree_util.tree_map(np.asarray, tree)
        p = tlstm.params_from_jax(np_tree, "cpu")
        rng = np.random.default_rng(5)
        h, c = (rng.standard_normal((2, 16)).astype(np.float32) for _ in range(2))
        x = rng.standard_normal((2, 8)).astype(np.float32)
        want = jax.jit(lambda *a: jlstm.cell_step(tree, *a))(h, c, x)
        got = tlstm.cell_step(p, *(torch.from_numpy(a) for a in (h, c, x)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        xs = rng.standard_normal((2, 12, 8)).astype(np.float32)
        seq_j = jlstm.build_sequence(8, 16, seq_len=12, params=tree)
        seq_t = tlstm.build_sequence(8, 16, seq_len=12, params=np_tree, device="cpu")
        want = np.asarray(jax.jit(seq_j.fn())(jnp.asarray(xs)))
        got = seq_t(torch.from_numpy(xs)).numpy()
        assert got.shape == want.shape == (2, 12, 16)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        assert tuple(seq_t.output_spec.tensors[0].shape) == (12, 16)


class TestCheckpoint:
    def test_repo_snapshot_restore(self):
        trepo.GLOBAL_REPO.set_buffer(3, TFrame.of(torch.arange(4), pts=7), None)
        snap = tckpt.snapshot_repo()
        assert isinstance(snap["3"]["frame"]["tensors"][0], np.ndarray)
        trepo.GLOBAL_REPO.reset()
        tckpt.restore_repo(snap)
        frame, _, eos = trepo.GLOBAL_REPO.get_buffer(3, timeout=1)
        assert not eos and frame.pts == 7
        assert isinstance(frame.tensor(0), torch.Tensor)
        np.testing.assert_array_equal(frame.tensor(0).numpy(), np.arange(4))

    def test_repo_cycle_resume_skips_bootstrap(self, tmp_path):
        trepo.GLOBAL_REPO.set_buffer(5, TFrame.of(torch.full((4,), 7.0), pts=42), None)
        path = str(tmp_path / "repo.npz")
        tckpt.save_state({"repo": tckpt.snapshot_repo()}, path)
        trepo.GLOBAL_REPO.reset()
        h = tnns.parse_launch(f"tensor_reposrc slot_index=5 device=cpu caps='{CAPS4}' ! "
                              "tensor_sink name=out collect=true")
        tckpt.restore_repo(tckpt.load_state(path)["repo"])
        sink = h.nodes["out"]
        h.start()
        deadline = time.monotonic() + 10
        while sink.num_frames < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        trepo.GLOBAL_REPO.set_eos(5)
        assert h.wait(10)
        h.stop()
        assert sink.num_frames == 1  # no zero bootstrap
        np.testing.assert_array_equal(sink.frames[0].tensor(0).numpy(), np.full((4,), 7.0))

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_checkpoint_crosses_packages(self, tmp_path, writer):
        """A repo checkpoint written by one package restores in the other:
        the frame's values, dtype, timing and meta, and the EOS flag."""
        path = str(tmp_path / "ck.npz")
        x = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
        if writer == "port":
            trepo.GLOBAL_REPO.set_buffer(4, TFrame.of(torch.from_numpy(x), pts=9, duration=3,
                                                      tag="h"), None)
            trepo.GLOBAL_REPO.set_eos(8)
            tckpt.save_state({"repo": tckpt.snapshot_repo(), "nodes": {}}, path)
            jckpt.restore_repo(jckpt.load_state(path)["repo"])
            repo = jrepo.GLOBAL_REPO
        else:
            jrepo.GLOBAL_REPO.set_buffer(4, JFrame.of(x, pts=9, duration=3, tag="h"), None)
            jrepo.GLOBAL_REPO.set_eos(8)
            jckpt.save_state({"repo": jckpt.snapshot_repo(), "nodes": {}}, path)
            tckpt.restore_repo(tckpt.load_state(path)["repo"], device="cpu")
            repo = trepo.GLOBAL_REPO
        frame, _, eos = repo.get_buffer(4, timeout=1)
        got = _host(frame.tensor(0))
        assert not eos and got.dtype == np.float32
        np.testing.assert_array_equal(got, x)
        assert (frame.pts, frame.duration, frame.meta["tag"]) == (9, 3, "h")
        assert repo.slot(8).eos and repo.slot(4).restored

    @pytest.mark.parametrize("framework", ["custom-python", "torch"])
    def test_cycle_resumes_where_it_stopped(self, tmp_path, framework):
        """Config 4 stopped after 6 steps, checkpointed, restored into a new
        pipeline and run 6 more: bit for bit the 12 steps of one run, in the
        port, and the port's checkpoint resumes the reference's pipeline to
        the reference's own uninterrupted steps."""
        xs = _xs(12, 4 if framework != "torch" else 16, seed=2)
        if framework == "torch":
            tree = jlstm.init_params(jax.random.PRNGKey(1), 16, 16)
            model = tlstm.build_cell(16, 16, params=jax.tree_util.tree_map(np.asarray, tree),
                                     device="cpu")
            jmodel, jframework = jlstm.build_cell(16, 16, params=tree), "jax"
        else:
            model, jmodel, jframework = PORT_LSTM, JAX_LSTM, "custom-python"
        whole, _ = _run_cycle("port", xs, framework, model)
        first, p1 = _run_cycle("port", xs[:6], framework, model)
        path = str(tmp_path / "cycle.npz")
        state = tckpt.checkpoint_pipeline(p1, path)
        assert state["repo"]["10"]["frame"] is not None
        trepo.GLOBAL_REPO.reset()
        p2, out2 = _cycle("port", xs[6:], framework, model)
        tckpt.restore_pipeline(p2, path)
        p2.run(timeout=60)
        rest = [_host(f.tensor(0)) for f in out2.frames]
        np.testing.assert_array_equal(np.stack(first + rest), np.stack(whole))

        jwhole, _ = _run_cycle("jax", xs, jframework, jmodel)
        jrepo.GLOBAL_REPO.reset()
        p3, out3 = _cycle("jax", xs[6:], jframework, jmodel)
        jckpt.restore_pipeline(p3, path)
        p3.run(timeout=60)
        jrest = [_host(f.tensor(0)) for f in out3.frames]
        np.testing.assert_allclose(np.stack(jrest), np.stack(jwhole[6:]), rtol=0, atol=2e-6)

"""The port's streaming training against the JAX package's.

``nnstreamer_tpu_torch.training`` and ``tensor_trainer`` held against
``nnstreamer_tpu.training`` (optax) and its element, with inputs made from
a numpy seed: the losses, one step of each optimizer on the same gradients
(rtol 1e-6 in float32), the reference's ``tests/test_trainer.py`` cases,
MobileNet-v2 at width 0.35 and 96x96 carried across with
``params_from_jax`` (3 steps, float32), a trainer checkpoint written by
each package and resumed by the other, and ``devices=2`` refused.  On the
CPU every step runs eagerly; the captured step is held on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu import training as jtraining
from nnstreamer_tpu.backends.jax_backend import JaxModel
from nnstreamer_tpu.buffer import Frame as JFrame
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu.elements.testsrc import DataSrc as JDataSrc
from nnstreamer_tpu.elements.trainer import TensorTrainer as JTrainer
from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.spec import TensorSpec as JTensorSpec
from nnstreamer_tpu.spec import TensorsSpec as JTensorsSpec
from nnstreamer_tpu.utils import checkpoint as jcheckpoint
from nnstreamer_tpu_torch import training
from nnstreamer_tpu_torch.backends.torch_backend import TorchModel
from nnstreamer_tpu_torch.buffer import Frame
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.testsrc import DataSrc
from nnstreamer_tpu_torch.elements.trainer import TensorTrainer
from nnstreamer_tpu_torch.graph.node import NegotiationError
from nnstreamer_tpu_torch.models import mobilenet_v2
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec
from nnstreamer_tpu_torch.training import (LOSSES, make_optimizer, make_train_step, mse,
                                           softmax_cross_entropy)
from nnstreamer_tpu_torch.utils import checkpoint

F32 = np.float32
# optimizer specs held against optax, one step on the same gradients
SPECS = ["adam,lr=1e-2", "adam,lr=3e-3,b1=0.8,b2=0.99,eps=1e-6,eps_root=1e-8",
         "adamw,lr=1e-2", "adamw,lr=1e-2,weight_decay=0.05", "sgd,lr=0.1",
         "sgd,lr=0.1,momentum=0.9", "sgd,lr=0.1,momentum=0.9,nesterov=1", "rmsprop,lr=1e-2",
         "rmsprop,lr=1e-2,decay=0.95,eps=1e-6,initial_scale=0.1",
         "rmsprop,lr=1e-2,momentum=0.5", "rmsprop,lr=1e-2,eps_in_sqrt=0"]
STEP_RTOL = 1e-6  # one optimizer step, float32, the same gradients


def linreg_model(d=4, k=2, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d, k)).astype(F32) * 0.1
    return TorchModel(apply=lambda p, x: x @ p, params=torch.from_numpy(w),
                      input_spec=TensorsSpec.of(TensorSpec(dtype=F32, shape=(8, d))),
                      device="cpu")


def jax_linreg_model(d=4, k=2, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d, k)).astype(F32) * 0.1
    return JaxModel(apply=lambda p, x: x @ p, params=jnp.asarray(w),
                    input_spec=JTensorsSpec.of(JTensorSpec(dtype=F32, shape=(8, d))))


def _spec2(shape_x=(8, 4), shape_y=(8, 2), y_dtype=F32):
    return TensorsSpec.of(TensorSpec(dtype=F32, shape=shape_x),
                          TensorSpec(dtype=y_dtype, shape=shape_y))


def _jspec2(shape_x=(8, 4), shape_y=(8, 2)):
    return JTensorsSpec.of(JTensorSpec(dtype=F32, shape=shape_x),
                           JTensorSpec(dtype=F32, shape=shape_y))


def _leaves_np(tree):
    return [np.asarray(l) for l in training.tree_flatten(tree)[0]]


# -- losses and optimizers ------------------------------------------------------


class TestTrainingCore:
    def test_losses_analytic(self):
        logits = torch.tensor([[2.0, 0.0], [0.0, 2.0]])
        want = float(-np.log(np.exp(2) / (np.exp(2) + 1)))
        assert abs(float(softmax_cross_entropy(logits, torch.tensor([0, 1]))) - want) < 1e-6
        onehot = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
        assert abs(float(softmax_cross_entropy(logits, onehot)) - want) < 1e-6
        assert float(mse(torch.ones(3), torch.zeros(3))) == 1.0
        assert set(LOSSES) == set(jtraining.LOSSES)

    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
    def test_losses_equal_the_reference(self, seed, dtype):
        rng = np.random.default_rng(seed)
        logits = rng.standard_normal((16, 10)).astype(F32) * 4
        labels = rng.integers(0, 10, 16).astype(np.int32)
        onehot = np.eye(10, dtype=F32)[labels]
        target = rng.standard_normal((16, 10)).astype(F32)
        t = torch.from_numpy(logits)
        j = jnp.asarray(logits)
        if dtype == "bfloat16":  # logits from a bfloat16 model: float32 math after the cast
            t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
        pairs = [(softmax_cross_entropy(t, torch.from_numpy(labels)),
                  jtraining.softmax_cross_entropy(j, jnp.asarray(labels))),
                 (softmax_cross_entropy(t, torch.from_numpy(onehot)),
                  jtraining.softmax_cross_entropy(j, jnp.asarray(onehot))),
                 (mse(t, torch.from_numpy(target)), jtraining.mse(j, jnp.asarray(target)))]
        for ours, theirs in pairs:
            assert ours.dtype == torch.float32
            np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)

    def test_optimizer_spec_parsing(self):
        for spec in ("adam,lr=1e-3", "sgd,lr=0.1,momentum=0.9", "adamw,lr=3e-4",
                     "rmsprop,lr=1e-2"):
            assert make_optimizer(spec) is not None
        with pytest.raises(ValueError):
            make_optimizer("lion,lr=1")
        with pytest.raises(ValueError):
            make_optimizer("adam,lr")
        with pytest.raises(ValueError, match="centered"):
            make_optimizer("rmsprop,lr=1e-2,centered=1")
        assert make_optimizer("adam").lr == 1e-3

    @pytest.mark.parametrize("spec", SPECS)
    def test_one_step_equals_optax(self, spec):
        """One update on the same parameters and gradients: parameters and
        state leaf for leaf, in optax's layout, at rtol 1e-6 (float32)."""
        rng = np.random.default_rng(SPECS.index(spec))
        shapes = [(5, 3), (3,), (2, 2, 4)]
        params = [rng.standard_normal(s).astype(F32) for s in shapes]
        tx = jtraining.make_optimizer(spec)
        jstate = tx.init([jnp.asarray(p) for p in params])
        ours = make_optimizer(spec)
        tparams = [torch.from_numpy(p.copy()) for p in params]
        tstate = ours.init(tparams)
        assert jax.tree.structure(jstate).num_leaves == len(training.tree_flatten(tstate)[0])
        jp = [jnp.asarray(p) for p in params]
        for _ in range(2):  # the second step reads the first one's state
            grads = [rng.standard_normal(s).astype(F32) for s in shapes]
            updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
            jp = optax.apply_updates(jp, updates)
            ours.update([torch.from_numpy(g) for g in grads], tstate, tparams)
            for a, b in zip(jp, tparams):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=STEP_RTOL, atol=1e-7)
            for a, b in zip(jax.tree.leaves(jstate), _leaves_np(tstate)):
                assert np.asarray(a).dtype == b.dtype and np.asarray(a).shape == b.shape
                np.testing.assert_allclose(b, np.asarray(a), rtol=STEP_RTOL, atol=1e-7)

    @pytest.mark.parametrize("spec", ["adam,lr=1e-2", "sgd,lr=0.1,momentum=0.9",
                                      "rmsprop,lr=1e-2", "adamw,lr=1e-2"])
    def test_train_steps_equal_the_reference(self, spec):
        """Five whole steps (forward, gradients, update) of a dict model with
        an int leaf, in both packages."""
        rng = np.random.default_rng(11)
        w, b = rng.standard_normal((6, 3)).astype(F32), rng.standard_normal(3).astype(F32)
        xs = [rng.standard_normal((8, 6)).astype(F32) for _ in range(5)]
        ys = [rng.integers(0, 3, 8).astype(np.int32) for _ in range(5)]
        ji, js = jtraining.make_train_step(lambda p, a: a @ p["w"] + p["b"], "softmax_ce", spec,
                                           donate=False)
        ti, ts = make_train_step(lambda p, a: a @ p["w"] + p["b"], "softmax_ce", spec)
        jp = {"w": jnp.asarray(w), "b": jnp.asarray(b), "n": jnp.asarray([1, 2], jnp.int32)}
        tp = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy()),
              "n": torch.tensor([1, 2], dtype=torch.int32)}
        jo, to = ji(jp), ti(tp)
        for x, y in zip(xs, ys):
            jp, jo, jl = js(jp, jo, x, y)
            tp, to, tl = ts(tp, to, x, y)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for key in ("w", "b"):
            np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), rtol=1e-4,
                                       atol=1e-6)
        assert tp["n"].tolist() == [1, 2]

    def test_sgd_step_matches_manual_gradient(self):
        """One SGD step on mse == params - lr * analytic grad, exactly."""
        w = torch.tensor([[1.0], [2.0]])
        x = torch.tensor([[1.0, 1.0]])
        y = torch.tensor([[0.0]])
        init, step = make_train_step(lambda p, a: a @ p, loss="mse", optimizer="sgd,lr=0.5",
                                     donate=False)
        p1, _, loss = step(w, init(w), x, y)
        assert float(loss) == 9.0
        np.testing.assert_allclose(p1.numpy(), [[-2.0], [-1.0]], rtol=1e-6)
        assert w.tolist() == [[1.0], [2.0]]  # donate=False leaves the caller's tree

    def test_loss_decreases_in_place_constant_buffers(self):
        model = linreg_model()
        rng = np.random.default_rng(1)
        true_w = rng.standard_normal((4, 2)).astype(F32)
        init, step = make_train_step(model.apply, loss="mse", optimizer="adam,lr=0.05")
        params = model.params.clone()
        opt = init(params)
        ptrs = [params.data_ptr()] + [t.data_ptr() for t in training._state_tensors(opt)]
        losses = []
        for _ in range(60):
            x = rng.standard_normal((8, 4)).astype(F32)
            params, opt, loss = step(params, opt, x, x @ true_w)
            losses.append(float(loss))
        assert losses[-1] < 0.05 * losses[0]
        # donation's counterpart: the same tensors, updated in place
        assert [params.data_ptr()] + [t.data_ptr() for t in training._state_tensors(opt)] == ptrs
        assert int(opt[0][0]) == 60

    def test_int_array_leaf_rides_as_static(self):
        params = {"w": torch.ones(4, 2), "mask": torch.tensor([1, 0, 1, 0], dtype=torch.int32)}

        def apply_fn(p, x):
            return (x * p["mask"].to(torch.float32)) @ p["w"]

        init, step = make_train_step(apply_fn, loss="mse", optimizer="sgd,lr=0.1",
                                     donate=False)
        opt = init(params)
        x, y = np.ones((3, 4), F32), np.zeros((3, 2), F32)
        p1, opt, l1 = step(params, opt, x, y)
        p2, opt, l2 = step(p1, opt, x, y)
        assert float(l2) < float(l1)
        assert p2["mask"].tolist() == [1, 0, 1, 0]

    def test_tree_order_is_jax_order(self):
        tree = {"b": [1, None, torch.zeros(2)], "a": (torch.ones(1), {"z": 3, "y": 2.5}),
                "c": None}
        jtree = {"b": [1, None, np.zeros(2)], "a": (np.ones(1), {"z": 3, "y": 2.5}), "c": None}
        ours, treedef = training.tree_flatten(tree)
        theirs = jax.tree.leaves(jtree)
        assert [type(l).__name__ if not isinstance(l, torch.Tensor) else "arr" for l in ours] \
            == [type(l).__name__ if not isinstance(l, np.ndarray) else "arr" for l in theirs]
        assert training.tree_unflatten(treedef, ours)["a"][1] == {"y": 2.5, "z": 3}


# -- the element ----------------------------------------------------------------


def _run_training(n_frames=60, lr=0.08, pkg="port"):
    rng = np.random.default_rng(2)
    true_w = rng.standard_normal((4, 2)).astype(F32)
    xs = [rng.standard_normal((8, 4)).astype(F32) for _ in range(n_frames)]
    curve = []
    if pkg == "port":
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[Frame.of(torch.from_numpy(x), torch.from_numpy(x @ true_w),
                                           pts=i) for i, x in enumerate(xs)]))
        trainer = p.add(TensorTrainer(model=linreg_model(), loss="mse",
                                      optimizer=f"adam,lr={lr}"))
        sink = p.add(TensorSink())
    else:
        p = jnns.Pipeline()
        src = p.add(JDataSrc(data=[JFrame.of(x, x @ true_w, pts=i) for i, x in enumerate(xs)]))
        trainer = p.add(JTrainer(model=jax_linreg_model(), loss="mse",
                                 optimizer=f"adam,lr={lr}"))
        sink = p.add(JSink())
    sink.connect("new-data", lambda f: curve.append(
        (float(np.asarray(f.tensor(0))), int(np.asarray(f.tensor(1))))))
    p.link_chain(src, trainer, sink)
    p.run(timeout=120)
    return trainer, curve, true_w


class TestTrainerElement:
    def test_streams_learning_curve_and_learns(self):
        trainer, curve, true_w = _run_training()
        assert len(curve) == 60
        assert [s for _, s in curve] == list(range(1, 61))
        assert curve[-1][0] < 0.1 * curve[0][0]
        assert np.abs(trainer.params - true_w).mean() < 0.5
        assert trainer.last_loss == pytest.approx(curve[-1][0])

    def test_learning_curve_equals_the_reference(self):
        ours, curve, _ = _run_training(n_frames=20)
        theirs, jcurve, _ = _run_training(n_frames=20, pkg="jax")
        np.testing.assert_allclose([l for l, _ in curve], [l for l, _ in jcurve], rtol=1e-4)
        np.testing.assert_allclose(ours.params, theirs.params, rtol=1e-4, atol=1e-6)

    def test_trained_params_feed_a_filter(self):
        """Train → hand the params to tensor_filter → predictions match."""
        trainer, _, true_w = _run_training(n_frames=80, lr=0.1)
        trained = TorchModel(apply=lambda p, x: x @ p, params=torch.from_numpy(trainer.params),
                             input_spec=TensorsSpec.of(TensorSpec(dtype=F32, shape=(8, 4))),
                             device="cpu")
        x = np.random.default_rng(3).standard_normal((8, 4)).astype(F32)
        got = []
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=[torch.from_numpy(x)]))
        filt = p.add(TensorFilter(framework="torch", model=trained))
        sink = p.add(TensorSink())
        sink.connect("new-data", lambda f: got.append(np.asarray(f.tensor(0))))
        p.link_chain(src, filt, sink)
        p.run(timeout=120)
        np.testing.assert_allclose(got[0], x @ true_w, atol=0.7)

    def test_classification_with_mux_topology(self):
        rng = np.random.default_rng(4)
        n, d, cls, steps = 16, 6, 3, 50
        w_true = rng.standard_normal((d, cls)).astype(F32) * 2
        xs, ys = [], []
        for _ in range(steps):
            x = rng.standard_normal((n, d)).astype(F32)
            xs.append(torch.from_numpy(x))
            ys.append(torch.from_numpy(np.argmax(x @ w_true, axis=-1).astype(np.int32)))
        model = TorchModel(apply=lambda p, x: x @ p, params=torch.zeros(d, cls),
                           input_spec=TensorsSpec.of(TensorSpec(dtype=F32, shape=(n, d))),
                           device="cpu")
        curve = []
        p = tnns.Pipeline()
        xsrc = p.add(DataSrc(data=xs, name="x"))
        ysrc = p.add(DataSrc(data=ys, name="y"))
        mux = p.add(tnns.make("tensor_mux", sync_mode="nosync"))
        trainer = p.add(TensorTrainer(model=model, loss="softmax_ce", optimizer="adam,lr=0.1"))
        sink = p.add(TensorSink())
        sink.connect("new-data", lambda f: curve.append(float(np.asarray(f.tensor(0)))))
        p.link(xsrc, f"{mux.name}.sink_0")
        p.link(ysrc, f"{mux.name}.sink_1")
        p.link_chain(mux, trainer, sink)
        p.run(timeout=120)
        assert len(curve) == steps and trainer.step_count == steps
        assert curve[-1] < 0.3 * curve[0]

    def test_parse_launch_spelling(self):
        p = tnns.parse_launch("datasrc name=s ! tensor_trainer name=tr loss=mse "
                              "optimizer=sgd,lr=0.1 ! tensor_sink name=out")
        assert isinstance(p["tr"], TensorTrainer)
        assert (p["tr"].loss, p["tr"].optimizer) == ("mse", "sgd,lr=0.1")
        rng = np.random.default_rng(5)
        x = rng.standard_normal((8, 4)).astype(F32)
        p["s"].data = [Frame.of(torch.from_numpy(x), torch.from_numpy(x @ np.ones((4, 2), F32)))
                       for _ in range(3)]
        p["tr"].model = linreg_model()
        got = []
        p["out"].connect("new-data", got.append)
        p.run(timeout=60)
        assert len(got) == 3 and p["tr"].step_count == 3
        assert got[-1].tensor(0).dtype == torch.float32 and got[-1].tensor(0).shape == ()
        assert got[-1].tensor(1).dtype == torch.int32 and int(got[-1].tensor(1)) == 3

    @staticmethod
    def _fresh(optimizer="adam,lr=0.05"):
        t = TensorTrainer(model=linreg_model(), loss="mse", optimizer=optimizer)
        t.configure({"sink": _spec2()})
        return t

    @staticmethod
    def _data(seed, n=6):
        rng = np.random.default_rng(seed)
        return [Frame.of(torch.from_numpy(x), torch.from_numpy(x @ np.ones((4, 2), F32)), pts=i)
                for i, x in enumerate(rng.standard_normal((8, 4)).astype(F32)
                                      for _ in range(n))]

    def test_checkpoint_resume_roundtrip(self, tmp_path):
        data = self._data(6)
        a = self._fresh()
        for f in data:
            a.process(None, f)
        b = self._fresh()
        for f in data[:3]:
            b.process(None, f)
        checkpoint.save_state(b.state_dict(), str(tmp_path / "tr.npz"))
        c = self._fresh()
        ptr = c._params.data_ptr()
        c.load_state(checkpoint.load_state(str(tmp_path / "tr.npz")))
        assert c.step_count == 3 and c._params.data_ptr() == ptr  # restored in place
        for f in data[3:]:
            c.process(None, f)
        np.testing.assert_allclose(c.params, a.params, rtol=1e-5, atol=1e-6)

    def test_restore_before_configure(self):
        data = self._data(10)
        a = self._fresh()
        for f in data:
            a.process(None, f)
        b = self._fresh()
        for f in data[:3]:
            b.process(None, f)
        state = b.state_dict()
        c = TensorTrainer(model=linreg_model(), loss="mse", optimizer="adam,lr=0.05")
        c.load_state(state)  # before configure: deferred
        assert c.step_count == 3
        c.configure({"sink": _spec2()})
        for f in data[3:]:
            c.process(None, f)
        np.testing.assert_allclose(c.params, a.params, rtol=1e-5, atol=1e-6)

    def test_non_divisible_batch_rejected_at_configure(self):
        t = TensorTrainer(model=linreg_model(), devices=3)
        with pytest.raises(NegotiationError, match="divisible"):
            t.configure({"sink": _spec2()})

    def test_devices_refused_naming_item_13(self):
        t = TensorTrainer(model=linreg_model(), devices=2)
        with pytest.raises(NegotiationError, match="item 13b"):
            t.configure({"sink": _spec2()})

    def test_model_params_not_aliased(self):
        model = linreg_model()
        orig = model.params.clone()
        t = TensorTrainer(model=model, loss="mse", optimizer="sgd,lr=0.1")
        t.configure({"sink": _spec2()})
        assert t._params is not model.params
        x = np.random.default_rng(8).standard_normal((8, 4)).astype(F32)
        for i in range(3):
            t.process(None, Frame.of(torch.from_numpy(x), torch.zeros(8, 2), pts=i))
        assert torch.equal(model.params, orig)
        assert not np.allclose(t.params, orig.numpy())

    @pytest.mark.parametrize("form", ["torch_model", "tuple"])
    def test_host_params_train_on_the_card_or_raise(self, form, monkeypatch):
        """Host params (numpy here) go to the model's device, the card by
        default: without one, configure raises as the filter does."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        w = np.zeros((4, 2), F32)
        model = (lambda p, x: x @ p, w) if form == "tuple" else TorchModel(
            apply=lambda p, x: x @ p, params=w)
        t = TensorTrainer(model=model, loss="mse")
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            t.configure({"sink": _spec2()})

    def test_host_params_follow_a_cpu_model(self):
        t = TensorTrainer(model=TorchModel(apply=lambda p, x: x @ p,
                                           params={"w": np.zeros((4, 2), F32),
                                                   "n": np.arange(3, dtype=np.int32)},
                                           device="cpu"), loss="mse")
        t.configure({"sink": _spec2()})
        assert all(l.device.type == "cpu" for l in (t._params["w"], t._params["n"]))

    def test_rejects_single_tensor_frames(self):
        t = TensorTrainer(model=linreg_model())
        with pytest.raises(NegotiationError, match="2 tensors"):
            t.configure({"sink": TensorsSpec.of(TensorSpec(dtype=F32, shape=(8, 4)))})

    def test_conv_model_with_static_config_leaves(self):
        """MobileNet's params tree carries Python-int and bool leaves
        (stride, residual): they stay static, outside the trained set."""
        model = mobilenet_v2.build(num_classes=4, width_mult=0.35, image_size=32,
                                   dtype=torch.float32, device="cpu")
        rng = np.random.default_rng(7)
        frames = [Frame.of(torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(F32)),
                           torch.tensor([i % 4, (i + 1) % 4], dtype=torch.int32), pts=i)
                  for i in range(3)]
        curve = []
        p = tnns.Pipeline()
        src = p.add(DataSrc(data=frames))
        trainer = p.add(TensorTrainer(model=TorchModel(
            apply=lambda pp, x: mobilenet_v2.apply(pp, x, dtype=torch.float32),
            params=model.params, input_spec=model.input_spec, device="cpu"),
            loss="softmax_ce", optimizer="sgd,lr=0.01"))
        sink = p.add(TensorSink())
        sink.connect("new-data", lambda f: curve.append(float(np.asarray(f.tensor(0)))))
        p.link_chain(src, trainer, sink)
        p.run(timeout=120)
        assert len(curve) == 3 and all(np.isfinite(v) for v in curve)
        strides = [b["stride"] for b in trainer._params["blocks"]]
        assert strides == [b["stride"] for b in model.params["blocks"]]


# -- MobileNet-v2 across the packages, and checkpoints both ways -----------------

MN_WIDTH, MN_IMAGE, MN_CLASSES, MN_BATCH, MN_STEPS = 0.35, 96, 10, 2, 3
MN_SPEC = "sgd,lr=1e-3,momentum=0.9"
MN_LOSS_RTOL = 1e-5   # float32 convs sum in another order (oneDNN against XLA): 4e-6 seen
MN_PARAM_ATOL = 1e-5  # the parameters move by up to 0.08 in 3 steps; 1.8e-7 apart seen


def test_relu6_gradient_is_jnp_clip_s():
    """At exactly 0 and 6 ``jnp.clip`` passes half the gradient (a tie of
    its maximum and minimum); the port's ``relu6`` does the same."""
    from nnstreamer_tpu.models import layers as jlayers
    from nnstreamer_tpu_torch.models import layers

    x = np.array([-1.0, 0.0, 0.5, 6.0, 6.5, 3.0, 0.0], F32)
    want = np.asarray(jax.grad(lambda a: (jlayers.relu6(a) * jnp.arange(7.0)).sum())(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    (layers.relu6(t) * torch.arange(7.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    with torch.no_grad():  # no autograd: one clamp, the same values
        assert torch.equal(layers.relu6(torch.from_numpy(x)), torch.clamp(
            torch.from_numpy(x), 0, 6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu6_forms_agree(dtype):
    """``tools/relu6_ab.py`` times the port's ``relu6`` against ``jnp.clip``'s
    own construction: the same values and gradients, ties included."""
    from nnstreamer_tpu_torch.models import layers
    from nnstreamer_tpu_torch.tools.relu6_ab import relu6_maxmin

    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-2, 8, 61), [0.0, 6.0, 0.0]]).astype(F32)
    w = torch.from_numpy(rng.standard_normal(x.size).astype(F32)).to(dtype)
    grads = []
    for fn in (layers.relu6, relu6_maxmin):
        t = torch.from_numpy(x).to(dtype).requires_grad_(True)
        out = fn(t)
        (out * w).sum().backward()
        grads.append((out.detach(), t.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


class TestMobileNetParity:
    def test_three_steps_equal_the_reference(self):
        jmodel = jmobilenet.build(num_classes=MN_CLASSES, width_mult=MN_WIDTH,
                                  image_size=MN_IMAGE, dtype=jnp.float32)
        tree = jax.tree.map(lambda a: np.asarray(a) if hasattr(a, "shape") else a,
                            jmodel.params)
        tparams = mobilenet_v2.params_from_jax(tree, device="cpu")
        rng = np.random.default_rng(12)
        batches = [(rng.uniform(-1, 1, (MN_BATCH, MN_IMAGE, MN_IMAGE, 3)).astype(F32),
                    rng.integers(0, MN_CLASSES, MN_BATCH).astype(np.int32))
                   for _ in range(MN_STEPS)]
        spec = MN_SPEC
        ji, js = jtraining.make_train_step(
            lambda p, x: jmobilenet.apply(p, x, dtype=jnp.float32), "softmax_ce", spec,
            donate=False)
        ti, ts = make_train_step(lambda p, x: mobilenet_v2.apply(p, x, dtype=torch.float32),
                                 "softmax_ce", spec)
        jp, tp = jmodel.params, tparams
        jo, to = ji(jp), ti(tp)
        assert len(training.tree_flatten(to)[0]) == len(jax.tree.leaves(jo))
        for x, y in batches:
            jp, jo, jl = js(jp, jo, x, y)
            tp, to, tl = ts(tp, to, x, y)
            np.testing.assert_allclose(float(tl), float(jl), rtol=MN_LOSS_RTOL)
        back = mobilenet_v2.params_to_jax(tp)
        theirs = jax.tree.leaves(jax.tree.map(np.asarray, jp))
        ours = jax.tree.leaves(back)
        assert len(ours) == len(theirs)
        worst = max(float(np.max(np.abs(np.asarray(a, F32) - np.asarray(b, F32))))
                    for a, b in zip(ours, theirs))
        assert worst < MN_PARAM_ATOL, worst


def _jfresh(optimizer="adam,lr=0.05"):
    t = JTrainer(model=jax_linreg_model(), loss="mse", optimizer=optimizer)
    t.configure({"sink": _jspec2()})
    return t


@pytest.mark.parametrize("optimizer", ["adam,lr=0.05", "sgd,lr=0.05,momentum=0.9",
                                       "rmsprop,lr=0.01"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_trainer_checkpoint_crosses_packages(tmp_path, optimizer, direction):
    """A trainer checkpoint written by one package and resumed by the other
    continues as the writer would have, step for step."""
    rng = np.random.default_rng(21)
    xs = [rng.standard_normal((8, 4)).astype(F32) for _ in range(6)]
    ys = [x @ np.ones((4, 2), F32) * 0.5 for x in xs]
    path = str(tmp_path / "trainer.npz")
    writer = _jfresh(optimizer) if direction == "jax_to_port" else \
        TestTrainerElement._fresh(optimizer)
    reader = TestTrainerElement._fresh(optimizer) if direction == "jax_to_port" else \
        _jfresh(optimizer)
    jaxside = direction == "jax_to_port"

    def frame(i, port):
        return Frame.of(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])) if port else \
            JFrame.of(xs[i], ys[i])

    for i in range(3):
        writer.process(None, frame(i, not jaxside))
    (jcheckpoint if jaxside else checkpoint).save_state(writer.state_dict(), path)
    reader.load_state((checkpoint if jaxside else jcheckpoint).load_state(path))
    assert reader.step_count == 3
    for i in range(3, 6):
        writer.process(None, frame(i, not jaxside))
        reader.process(None, frame(i, jaxside))
    np.testing.assert_allclose(np.asarray(reader.params), np.asarray(writer.params),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, writer.state_dict()["opt_state"])),
                    jax.tree.leaves(jax.tree.map(np.asarray, reader.state_dict()["opt_state"]))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_example_train_stream_on_the_cpu():
    """The port's ``examples/train_stream.py``, as the JAX package's example
    runs it: it learns, and the deployed filter classifies."""
    from nnstreamer_tpu_torch.examples import train_stream

    out = train_stream.main(device="cpu")
    assert out["steps"] == 80 and out["last_loss"] < 0.3 * out["first_loss"]
    assert out["accuracy"] > 0.8


@pytest.mark.parametrize("case", ["later_on_a_thread", "later_on_main", "no_window",
                                  "later_freed", "replays_the_later"])
def test_profiled_replay_hazard_is_refused_typed(case):
    """ROADMAP C16: inside a profiler window (the capture lock held) a
    training graph refuses to replay, typed, while a graph captured after it
    on another thread than the main one lives; outside the window, with the
    later graph captured on the main thread or freed, or for the later graph
    itself, it replays."""
    import gc
    import threading

    from nnstreamer_tpu_torch.obs import profiler

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    def captured():
        t = torch.zeros(1)
        return training._Captured(Graph(), t.clone(), t.clone(), t.clone())

    first = captured()
    box = []
    if case == "later_on_main":
        box.append(captured())
    else:
        th = threading.Thread(target=lambda: box.append(captured()))
        th.start()
        th.join()
    target = box[0] if case == "replays_the_later" else first
    if case == "later_freed":
        box.clear()
        gc.collect()
    x = torch.ones(1)
    if case == "no_window":
        target.run(x, x)
        return
    with profiler.capture_lock("c16 test"):
        if case == "later_on_a_thread":
            with pytest.raises(profiler.ProfiledReplayHazard, match="C16"):
                target.run(x, x)
            assert Graph.replays == 0
        else:
            target.run(x, x)
            assert Graph.replays == 1

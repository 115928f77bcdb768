"""The examples' golden checks, run against the port.

Each of the three examples with a golden check runs its pipeline, then
decodes the same frame in numpy from the raw model outputs of a
``SingleShot`` and holds the pipeline's result to it.  Here the pipeline is
the port's (on the CPU, the plain kernels), the raw outputs come from the
port's ``SingleShot`` on the same model, and the numpy decode is the
example's own: ``examples/pipelines/object_detection.py::golden_decode``
(loaded from the example file, which is not edited), and the decode steps
of ``fused_detection.py:56-91`` and ``pose_estimation.py:64-73``, written
out here as the examples write them.  Sizes and models are the examples':
SSD-MobileNet-v2 1.0 at 300x300 with 5 labels, its fused top-64 form, and
PoseNet at 224x224, random weights (seed 0), bfloat16.  Every comparison
is exact, the probabilities within the examples' 1e-6 (rounded) and 1e-5.
"""

import importlib.util
from pathlib import Path

import numpy as np
import torch

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.decoders.bounding_boxes import DETECTION_THRESHOLD, decode_tflite_ssd, px
from nnstreamer_tpu_torch.api.single import SingleShot
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.testsrc import VideoTestSrc
from nnstreamer_tpu_torch.models import posenet, ssd_mobilenet

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "pipelines"


def example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def normalized(frame):
    return (frame.astype(np.float32) - 127.5) / 127.5


def run_chain(model, n, size, decoder, pattern="smpte"):
    p = tnns.Pipeline()
    chain = [p.add(tnns.make("videotestsrc", num_buffers=n, width=size, height=size,
                             pattern=pattern)),
             p.add(tnns.make("tensor_converter")),
             p.add(tnns.make("tensor_transform", mode="arithmetic",
                             option="typecast:float32,add:-127.5,div:127.5", device="cpu")),
             p.add(TensorFilter(framework="torch", model=model)),
             p.add(tnns.make("tensor_decoder", **decoder)),
             p.add(tnns.make("tensor_sink", collect=True))]
    p.link_chain(*chain)
    p.run(timeout=600)
    assert len(chain[-1].frames) == n
    return chain[-1].frames


def test_object_detection_golden(tmp_path):
    ex = example("object_detection")
    size, labels = ex.SIZE, ex.LABELS
    model = ssd_mobilenet.build(num_labels=labels, image_size=size, device="cpu")
    priors = ssd_mobilenet.write_priors_file(str(tmp_path / "priors.txt"))
    label_file = tmp_path / "labels.txt"
    label_file.write_text("\n".join(["background"] + [f"object_{i}" for i in range(1, labels)]))
    frames = run_chain(model, 2, size, dict(mode="bounding_boxes", option1="tflite-ssd",
                                            option2=str(label_file), option3=priors,
                                            option4=f"{size}:{size}", option5=f"{size}:{size}"))
    x = normalized(VideoTestSrc(width=size, height=size)._make_frame(0))
    with SingleShot(framework="torch", model=model, device="cpu") as s:
        raw_boxes, raw_scores = (t.numpy() for t in s.invoke(torch.from_numpy(x)))
    golden = ex.golden_decode(raw_boxes, raw_scores, ssd_mobilenet.generate_priors())
    got = [{"class_id": o.class_id, "prob": round(o.prob, 6), "x": o.x, "y": o.y,
            "w": o.width, "h": o.height} for o in frames[0].meta["objects"]]
    want = [{**{k: g[k] for k in ("class_id", "x", "y", "w", "h")}, "prob": round(g["prob"], 6)}
            for g in golden]
    assert got == want and got


def test_fused_detection_golden():
    ex = example("fused_detection")
    size, labels, topk = ex.SIZE, ex.LABELS, ex.TOPK
    model = ssd_mobilenet.build(num_labels=labels, image_size=size, fused_decode=topk,
                                device="cpu")
    frames = run_chain(model, 4, size, dict(mode="bounding_boxes", option1="fused-ssd",
                                            option4=f"{size}:{size}", option5=f"{size}:{size}"),
                       pattern="random")
    # fused_detection.py:56-91: the raw model on the same pixels, decoded in
    # numpy, against the device decode of the same raw outputs
    raw = ssd_mobilenet.build(num_labels=labels, image_size=size, device="cpu")
    img = VideoTestSrc(width=size, height=size, pattern="random")._make_frame(0)
    x = torch.from_numpy(normalized(img))
    with SingleShot(framework="torch", model=raw, device="cpu") as s:
        boxes, scores = (t.numpy() for t in s.invoke(x))
    priors = ssd_mobilenet.generate_priors()
    sig = 1.0 / (1.0 + np.exp(-scores[:, 1:]))
    single = (sig >= DETECTION_THRESHOLD).sum(axis=1) == 1
    ref = decode_tflite_ssd(boxes[single], scores[single], priors[:, single], size, size)
    det = ssd_mobilenet.decode_topk(torch.from_numpy(boxes[single]),
                                    torch.from_numpy(scores[single]),
                                    torch.from_numpy(priors[:, single]),
                                    k=int(single.sum())).numpy()
    dev = {(max(0, px(r[0], size)), max(0, px(r[1], size)), px(r[2], size), px(r[3], size)):
           (int(r[4]), float(r[5])) for r in det if r[5] >= DETECTION_THRESHOLD}

    def match(o):
        got = dev.get((o.x, o.y, o.width, o.height))
        return got is not None and got[0] == o.class_id

    assert ref and len(ref) == len(dev) and all(match(o) for o in ref)
    # and the pipeline's frame 0 is the fused model's output on those pixels
    with SingleShot(framework="torch", model=model, device="cpu") as s:
        (fused,) = s.invoke(x)
    objs = frames[0].meta["objects"]
    rows = {(max(0, px(r[0], size)), max(0, px(r[1], size)), px(r[2], size), px(r[3], size)):
            int(r[4]) for r in fused.numpy() if r[5] >= DETECTION_THRESHOLD}
    assert objs and all(rows.get((o.x, o.y, o.width, o.height)) == o.class_id for o in objs)


def test_pose_estimation_golden(tmp_path):
    ex = example("pose_estimation")
    size = ex.SIZE
    model = posenet.build(image_size=size, device="cpu")
    grid = posenet.grid_size(size)
    joints = tmp_path / "joints.txt"
    joints.write_text("\n".join(ex.JOINTS))
    frames = run_chain(model, 2, size, dict(mode="pose_estimation", option1=f"{size}:{size}",
                                            option2=f"{grid}:{grid}", option3=str(joints)))
    x = normalized(VideoTestSrc(width=size, height=size)._make_frame(0))
    with SingleShot(framework="torch", model=model, device="cpu") as s:
        (heatmaps,) = (t.numpy() for t in s.invoke(torch.from_numpy(x)))
    # pose_estimation.py:64-73: a numpy argmax per keypoint channel
    golden = []
    for k in range(posenet.POSE_KEYPOINTS):
        hm = heatmaps[..., k]
        yy, xx = np.unravel_index(np.argmax(hm), hm.shape)
        golden.append((int(xx), int(yy), float(hm[yy, xx])))
    got = list(frames[0].meta["pose"])
    assert len(got) == posenet.POSE_KEYPOINTS
    for (gx, gy, gp), (wx, wy, wp) in zip(got, golden):
        assert (gx, gy) == (wx, wy)
        assert abs(gp - wp) < 1e-5

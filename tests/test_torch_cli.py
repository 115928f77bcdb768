"""``python -m nnstreamer_tpu_torch``, the port's gst-launch analog, against
the JAX package's CLI: the same report lines and exit codes (0 on success,
1 on a pipeline error or an unwritable ``--dot``, 2 on a parse error), in
process and as a subprocess, with ``--device cpu``.  ``--device cuda``
(the default) without a GPU exits nonzero with ``resolve_device``'s
message."""

import os
import re
import subprocess
import sys

import pytest
import torch

from nnstreamer_tpu.__main__ import main as jmain
from nnstreamer_tpu_torch.__main__ import main

PIPE = ("videotestsrc num-buffers=3 width=16 height=16 ! "
        "tensor_converter ! tensor_sink name=out")
NORM = ("videotestsrc num-buffers=4 width=16 height=16 ! tensor_converter ! "
        "tensor_transform mode=arithmetic option=typecast:float32,div:255.0{dev} ! "
        "tensor_sink name=out")


def _port_env():
    from conftest import cpu_subprocess_env

    env = cpu_subprocess_env()
    env.pop("NNSTPU_FILTER_TORCH_DEVICE", None)
    return env


def run_cli(args, timeout=120):
    return subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout, env=_port_env())


def _frames(out):
    """The per-frame report lines with the elapsed time taken out."""
    return [line for line in out.splitlines() if re.match(r"\w+: frame \d+ pts=", line)]


class TestSubprocess:
    def test_runs_pipeline_and_reports_frames(self):
        r = run_cli(["--device", "cpu", PIPE])
        assert r.returncode == 0, r.stderr[-500:]
        assert "out: frame 3" in r.stdout
        assert "EOS" in r.stdout and "3 sink frames" in r.stdout

    def test_quiet_and_dot(self, tmp_path):
        dot = str(tmp_path / "g.dot")
        r = run_cli(["--device", "cpu", "--quiet", "--dot", dot, PIPE])
        assert r.returncode == 0, r.stderr[-500:]
        assert "out: frame" not in r.stdout
        assert "digraph" in open(dot).read()

    def test_parse_error_is_rc2(self):
        r = run_cli(["--device", "cpu", "no_such_element ! tensor_sink"])
        assert r.returncode == 2
        assert "parse error" in r.stderr

    def test_cuda_without_a_gpu_exits_nonzero(self):
        """The default device is the card; with no GPU the CLI stops with
        resolve_device's message (this sandbox has none, the card machine
        has one: there the run succeeds)."""
        r = run_cli([PIPE])
        if torch.cuda.is_available():
            assert r.returncode == 0, r.stderr[-500:]
        else:
            assert r.returncode != 0
            assert "no CUDA GPU is available" in r.stderr


class TestInProcess:
    def test_report_lines_equal_the_reference(self, capsys):
        assert jmain([NORM.format(dev="")]) == 0
        want = capsys.readouterr().out
        assert main(["--device", "cpu", NORM.format(dev=" device=cpu")]) == 0
        got = capsys.readouterr().out
        assert _frames(got) == _frames(want) and len(_frames(got)) == 4
        assert "EOS after" in got and "4 sink frames" in got

    def test_quiet_suppresses_reports(self, capsys):
        assert main([PIPE, "--quiet", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "frame" not in out and "EOS" not in out

    def test_parse_error_rc2(self, capsys):
        assert jmain(["no_such_element ! tensor_sink"]) == 2
        capsys.readouterr()
        assert main(["no_such_element ! tensor_sink", "--device", "cpu"]) == 2
        assert "parse error" in capsys.readouterr().err

    def test_pipeline_error_rc1(self, capsys):
        """A negotiation failure at start is a pipeline error in both."""
        bad = "videotestsrc num-buffers=2 width=16 height=16 ! tensor_crop name=c ! tensor_sink"
        assert jmain([bad, "--quiet"]) == 1
        capsys.readouterr()
        assert main([bad, "--quiet", "--device", "cpu"]) == 1
        assert "pipeline error" in capsys.readouterr().err

    def test_dot_and_stats_on_success(self, tmp_path, capsys):
        dot = tmp_path / "g.dot"
        assert main([PIPE, "--dot", str(dot), "--stats", "--quiet", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "videotestsrc" in dot.read_text()
        assert f"pipeline graph -> {dot}" in out

    def test_unwritable_dot_fails_loud(self, tmp_path, capsys):
        rc = main([PIPE, "--quiet", "--device", "cpu",
                   "--dot", str(tmp_path / "nodir" / "g.dot")])
        assert rc == 1
        assert "dot dump failed" in capsys.readouterr().err

    def test_device_sets_the_filter_device(self, monkeypatch, tmp_path, capsys):
        """``--device cpu`` puts a model named in the string on the host."""
        monkeypatch.delenv("NNSTPU_FILTER_TORCH_DEVICE", raising=False)
        model = tmp_path / "double.py"
        model.write_text(
            "import numpy as np\n"
            "from nnstreamer_tpu_torch.backends.torch_backend import TorchModel\n"
            "from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec\n"
            "def get_model():\n"
            "    return TorchModel(apply=lambda p, x: x * 2, device='cpu',\n"
            "        input_spec=TensorsSpec.of(TensorSpec(np.uint8, (16, 16, 3))))\n")
        desc = (f"videotestsrc num-buffers=2 width=16 height=16 ! tensor_converter ! "
                f"tensor_filter framework=torch model={model} ! tensor_sink name=out")
        assert main([desc, "--device", "cpu"]) == 0
        assert os.environ["NNSTPU_FILTER_TORCH_DEVICE"] == "cpu"
        assert "out: frame 2" in capsys.readouterr().out

    def test_cuda_without_a_gpu_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main([PIPE, "--device", "cuda"])

"""The port's ``conf.py``: env > ini > defaults, and external plugins.

The JAX package's ``tests/test_conf.py`` cases (``TestLayering``,
``TestExternalPlugins``) against the port, with a plugin written for the
port; and each ported default held against the JAX package's
``DEFAULTS``.
"""

import importlib
import os
import sys
import textwrap

import pytest
import torch

from nnstreamer_tpu_torch.conf import Conf

# the modules, not the packages' process-wide ``conf`` objects
jax_conf = importlib.import_module("nnstreamer_tpu.conf")
port_conf = importlib.import_module("nnstreamer_tpu_torch.conf")


class TestDefaults:
    # The one default that differs: the port's entry points run on the card.
    DIFFERENT = {("filter", "torch_device"): ("cpu", "cuda")}

    @pytest.mark.parametrize("section,key", [(s, k) for s, keys in port_conf.DEFAULTS.items()
                                             for k in keys])
    def test_each_default_is_the_reference_one(self, section, key):
        ours = port_conf.DEFAULTS[section][key]
        theirs = jax_conf.DEFAULTS[section][key]
        assert (theirs, ours) == self.DIFFERENT.get((section, key), (ours, ours))

    def test_short_env_spellings_are_the_reference_ones(self):
        for name, target in port_conf.SHORT_ENV.items():
            assert jax_conf.SHORT_ENV[name] == target

    def test_device_default_is_the_card(self):
        c = Conf(ini_path="/nonexistent.ini", environ={})
        assert c.get("filter", "torch_device") == "cuda"
        c = Conf(ini_path="/nonexistent.ini", environ={"NNSTPU_FILTER_TORCH_DEVICE": "cpu"})
        assert c.get("filter", "torch_device") == "cpu"


class TestLayering:
    def test_defaults(self):
        c = Conf(ini_path="/nonexistent/nothing.ini", environ={})
        assert c.get("segment", "enabled") == "false"
        assert c.get_bool("segment", "enabled") is False
        assert c.get("common", "missing_key") is None
        assert c.get("common", "missing_key", "fallback") == "fallback"

    def test_ini_overrides_defaults(self, tmp_path):
        ini = tmp_path / "nnstreamer_tpu.ini"
        ini.write_text(textwrap.dedent("""
            [filter]
            torch_device = cpu
            [segment]
            enabled = yes
            """))
        c = Conf(ini_path=str(ini), environ={})
        assert c.get("filter", "torch_device") == "cpu"
        assert c.get_bool("segment", "enabled") is True

    def test_env_overrides_ini(self, tmp_path):
        ini = tmp_path / "n.ini"
        ini.write_text("[filter]\ntorch_device = cpu\n")
        c = Conf(ini_path=str(ini), environ={"NNSTPU_FILTER_TORCH_DEVICE": "cuda:1"})
        assert c.get("filter", "torch_device") == "cuda:1"

    def test_nnstpu_conf_env_points_at_ini(self, tmp_path):
        ini = tmp_path / "alt.ini"
        ini.write_text("[segment]\nenabled = on\n")
        c = Conf(environ={"NNSTPU_CONF": str(ini)})
        assert c.ini_path == str(ini)
        assert c.get_bool("segment", "enabled") is True

    def test_explicit_path_comes_before_nnstpu_conf(self, tmp_path):
        a, b = tmp_path / "a.ini", tmp_path / "b.ini"
        a.write_text("[segment]\nenabled = on\n")
        b.write_text("[segment]\nenabled = off\n")
        c = Conf(ini_path=str(a), environ={"NNSTPU_CONF": str(b)})
        assert c.ini_path == str(a) and c.get_bool("segment", "enabled")

    def test_ini_in_the_working_directory(self, tmp_path, monkeypatch):
        (tmp_path / "nnstreamer_tpu.ini").write_text("[filter]\ntorch_device = cpu\n")
        monkeypatch.chdir(tmp_path)
        c = Conf(environ={})
        assert c.ini_path == str(tmp_path / "nnstreamer_tpu.ini")
        assert c.get("filter", "torch_device") == "cpu"

    def test_typed_getters(self):
        env = {"NNSTPU_X_I": "42", "NNSTPU_X_F": "2.5", "NNSTPU_X_B": "off",
               "NNSTPU_X_P": "~/somewhere"}
        c = Conf(ini_path="/nonexistent.ini", environ=env)
        assert c.get_int("x", "i") == 42
        assert c.get_float("x", "f") == 2.5
        assert c.get_bool("x", "b", True) is False
        assert c.get_path("x", "p") == os.path.expanduser("~/somewhere")
        assert c.get_int("x", "missing", 7) == 7 and c.get_float("x", "missing", 1.5) == 1.5

    def test_bad_bool_raises(self):
        c = Conf(ini_path="/nonexistent.ini", environ={"NNSTPU_X_B": "maybe"})
        with pytest.raises(ValueError):
            c.get_bool("x", "b")

    def test_refresh_rereads_ini(self, tmp_path):
        ini = tmp_path / "n.ini"
        ini.write_text("[filter]\ntorch_device = cpu\n")
        c = Conf(ini_path=str(ini), environ={})
        assert c.get("filter", "torch_device") == "cpu"
        ini.write_text("[filter]\ntorch_device = cuda\n")
        c.refresh()
        assert c.get("filter", "torch_device") == "cuda"


PLUGIN_SRC = """
import torch
from nnstreamer_tpu_torch.backends.base import FilterBackend, register_backend
from nnstreamer_tpu_torch.graph.node import Node
from nnstreamer_tpu_torch.graph.registry import register_element
from nnstreamer_tpu_torch.elements.decoder import DecoderPlugin, register_decoder
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec
import numpy as np


@register_backend("test-negate")
class NegateBackend(FilterBackend):
    def open(self, model, custom=""):
        pass

    def reconfigure(self, in_spec):
        return in_spec

    def invoke(self, tensors):
        return tuple(-t for t in tensors)


@register_element("test_identity")
class IdentityElement(Node):
    def __init__(self, name=None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")


@register_decoder("test_sum")
class SumDecoder(DecoderPlugin):
    def out_spec(self, in_spec):
        return TensorsSpec(tensors=(TensorSpec(dtype=np.float32, shape=(1,)),))

    def decode(self, frame, in_spec):
        total = torch.tensor([sum(float(t.sum()) for t in frame.tensors)])
        return frame.with_tensors((total,))
"""


class TestExternalPlugins:
    @pytest.fixture()
    def plugin_dir(self, tmp_path, monkeypatch):
        pdir = tmp_path / "plugins"
        pdir.mkdir()
        (pdir / "nnstpu_testplug.py").write_text(PLUGIN_SRC)
        monkeypatch.setenv("NNSTPU_PLUGIN_PATH", str(pdir))
        return pdir

    def test_scan_finds_plugin_files(self, plugin_dir):
        c = Conf(ini_path="/nonexistent.ini")
        assert any(f.endswith("nnstpu_testplug.py") for f in c.scan_plugin_files())

    def test_non_plugin_files_ignored(self, plugin_dir):
        (plugin_dir / "other.py").write_text("raise RuntimeError('must not load')")
        c = Conf(ini_path="/nonexistent.ini")
        assert not any(f.endswith("other.py") for f in c.scan_plugin_files())

    def test_registry_miss_loads_plugin(self, plugin_dir):
        # the process-wide conf reads its env live: the plugin path counts
        from nnstreamer_tpu_torch.backends.base import get_backend
        from nnstreamer_tpu_torch.elements.decoder import get_decoder
        from nnstreamer_tpu_torch.graph.registry import make

        backend = get_backend("test-negate")
        backend.open(None)
        (out,) = backend.invoke((torch.ones(3),))
        assert torch.equal(out, -torch.ones(3))
        node = make("test_identity")
        assert node.sink_pads and node.src_pads
        assert get_decoder("test_sum") is not None

    def test_plugin_module_has_the_ports_prefix(self, plugin_dir):
        c = Conf(ini_path="/nonexistent.ini")
        assert c.load_external_plugins() == 1
        mod = sys.modules["nns_torch_plugins.nnstpu_testplug"]
        assert mod.__file__ == os.path.realpath(plugin_dir / "nnstpu_testplug.py")
        assert not sys.modules.get("nnstpu_plugins.nnstpu_testplug") is mod

    def test_plugin_loaded_once(self, plugin_dir):
        c = Conf(ini_path="/nonexistent.ini")
        assert c.load_external_plugins() >= 1
        assert c.load_external_plugins() == 0

    def test_ini_plugin_path(self, tmp_path, monkeypatch):
        monkeypatch.delenv("NNSTPU_PLUGIN_PATH", raising=False)
        pdir = tmp_path / "ini_plugins"
        pdir.mkdir()
        (pdir / "nnstpu_from_ini.py").write_text("LOADED = True\n")
        ini = tmp_path / "n.ini"
        ini.write_text(f"[common]\nplugin_path = {pdir}\n")
        c = Conf(ini_path=str(ini), environ={})
        assert c.plugin_dirs() == [str(pdir)]
        assert c.load_external_plugins() == 1

    def test_failing_plugin_surfaces_its_error_and_is_retried(self, tmp_path):
        pdir = tmp_path / "bad"
        pdir.mkdir()
        (pdir / "nnstpu_bad.py").write_text("import nnstpu_module_that_is_not_there\n")
        c = Conf(ini_path="/nonexistent.ini", environ={"NNSTPU_PLUGIN_PATH": str(pdir)})
        for _ in range(2):  # not marked as loaded: the next scan tries it again
            with pytest.raises(ModuleNotFoundError, match="nnstpu_module_that_is_not_there"):
                c.load_external_plugins()
        assert "nns_torch_plugins.nnstpu_bad" not in sys.modules

    def test_unknown_names_still_list_the_known_ones(self, tmp_path, monkeypatch):
        from nnstreamer_tpu_torch.backends.base import get_backend

        monkeypatch.setenv("NNSTPU_PLUGIN_PATH", str(tmp_path))
        with pytest.raises(ValueError, match="custom-so"):
            get_backend("no-such-framework")

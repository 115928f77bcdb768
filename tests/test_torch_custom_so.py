"""``custom-so`` in the port against the JAX package's, on the same ``.so``.

The JAX package's ``tests/test_custom_so.py`` cases: each filter is
compiled once for this module with ``g++`` against the port's copy of the
header (the same C ABI), and the JAX package's backend and the port's run
the same ``.so`` on the same inputs, bit for bit.  A filter with state
(``nns_init``'s scale, the dropper's frame count) gets one build per
package, since both would share one loaded library.  The port has no
``SingleShot`` yet, so the cases drive the backend and a pipeline directly.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.api.single import SingleShot
from nnstreamer_tpu_torch.backends.base import get_backend

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs a C++ toolchain")

HEADER_DIR = Path(__file__).resolve().parent.parent / "nnstreamer_tpu_torch" / "native"

SCALER_SRC = r"""
#include <cstring>
#include "nns_custom_filter.h"

static float g_scale = 2.0f;

extern "C" int nns_init(const char *custom) {
  if (custom && custom[0]) g_scale = atof(custom);
  return 0;
}

extern "C" int nns_get_input_spec(nns_tensors_spec *spec) {
  spec->num_tensors = 1;
  spec->tensors[0].dtype = NNS_FLOAT32;
  spec->tensors[0].rank = 2;
  spec->tensors[0].dims[0] = 3;
  spec->tensors[0].dims[1] = 4;
  return 0;
}

extern "C" int nns_get_output_spec(nns_tensors_spec *spec) {
  return nns_get_input_spec(spec);
}

extern "C" int nns_invoke(const void *const *in, const uint64_t *in_sz,
                          void *const *out, const uint64_t *out_sz) {
  if (in_sz[0] != out_sz[0]) return -1;
  const float *src = (const float *)in[0];
  float *dst = (float *)out[0];
  for (uint64_t i = 0; i < in_sz[0] / sizeof(float); ++i)
    dst[i] = src[i] * g_scale;
  return 0;
}
"""

DROPPER_SRC = r"""
#include "nns_custom_filter.h"

static int g_count = 0;

extern "C" int nns_get_input_spec(nns_tensors_spec *spec) {
  spec->num_tensors = 1;
  spec->tensors[0].dtype = NNS_UINT8;
  spec->tensors[0].rank = 1;
  spec->tensors[0].dims[0] = 4;
  return 0;
}

extern "C" int nns_get_output_spec(nns_tensors_spec *spec) {
  return nns_get_input_spec(spec);
}

extern "C" int nns_invoke(const void *const *in, const uint64_t *in_sz,
                          void *const *out, const uint64_t *out_sz) {
  if (++g_count % 2 == 0) return 1;  /* drop every second frame */
  for (uint64_t i = 0; i < in_sz[0]; ++i)
    ((unsigned char *)out[0])[i] = ((const unsigned char *)in[0])[i];
  return 0;
}
"""

CPP_CLASS_SRC = r"""
#include <cstring>
#include "nns_filter.hh"

class OffsetScale : public nns::Filter {
 public:
  int init(const char *custom) override {
    if (custom && custom[0]) offset_ = atof(custom);
    return 0;
  }
  int get_input_spec(nns_tensors_spec *spec) override {
    set_tensor(spec, 0, NNS_FLOAT32, {2, 5});
    return 0;
  }
  int get_output_spec(nns_tensors_spec *spec) override {
    return get_input_spec(spec);
  }
  int invoke(const void *const *in, const uint64_t *in_sz,
             void *const *out, const uint64_t *out_sz) override {
    if (in_sz[0] != out_sz[0]) return -1;
    const float *src = (const float *)in[0];
    float *dst = (float *)out[0];
    for (uint64_t i = 0; i < in_sz[0] / sizeof(float); ++i)
      dst[i] = src[i] * 3.0f + offset_;
    return 0;
  }

 private:
  float offset_ = 0.0f;
};
NNS_REGISTER_FILTER(OffsetScale)
"""

BUILDS = {"scaler": SCALER_SRC, "scaler_ref": SCALER_SRC, "scaler10": SCALER_SRC,
          "scaler10_ref": SCALER_SRC, "dropper": DROPPER_SRC, "dropper_ref": DROPPER_SRC,
          "offsetscale": CPP_CLASS_SRC, "offsetscale_ref": CPP_CLASS_SRC,
          "offsetscale2": CPP_CLASS_SRC, "offsetscale2_ref": CPP_CLASS_SRC,
          "bad": 'extern "C" int nothing(void) { return 0; }\n'}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every filter compiled once, as ``lib<name>.so``."""
    d = tmp_path_factory.mktemp("custom_so")
    out = {}
    for name, src in BUILDS.items():
        cc = d / f"{name}.cc"
        cc.write_text(f"#include <cstdlib>\n{src}")
        so = d / f"lib{name}.so"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", f"-I{HEADER_DIR}", str(cc), "-o",
                        str(so)], check=True, capture_output=True, text=True)
        out[name] = str(so)
    return out


def _port_invoke(so, x, custom=""):
    be = get_backend("custom-so")
    be.open(so, custom)
    try:
        return be, be.invoke((torch.from_numpy(x),))
    finally:
        be.close()


def _pipeline(nns, so, data, wrap, custom=""):
    got = []
    p = nns.Pipeline()
    src = p.add(nns.make("datasrc", data=[wrap(d) for d in data]))
    filt = p.add(nns.make("tensor_filter", framework="custom-so", model=so, custom=custom))
    sink = p.add(nns.make("tensor_sink", callback=got.append))
    p.link_chain(src, filt, sink)
    p.run(timeout=30)
    return [np.asarray(f.tensors[0]) for f in got]


class TestCustomSo:
    def test_scaler_roundtrip(self, libs, rng):
        x = rng.standard_normal((3, 4)).astype(np.float32)
        with SingleShot(framework="custom-so", model=libs["scaler_ref"]) as s:
            (want,) = s.invoke(x)
        be, (out,) = _port_invoke(libs["scaler"], x)
        assert be.input_spec().tensors[0].shape == (3, 4)
        assert be.output_spec().tensors[0].dtype == np.float32
        assert out.dtype == torch.float32 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        np.testing.assert_allclose(out.numpy(), x * 2.0, rtol=1e-6)

    def test_custom_property_reaches_init(self, libs, rng):
        x = rng.standard_normal((3, 4)).astype(np.float32)
        with SingleShot(framework="custom-so", model=libs["scaler10_ref"], custom="10.0") as s:
            (want,) = s.invoke(x)
        _, (out,) = _port_invoke(libs["scaler10"], x, custom="10.0")
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        np.testing.assert_allclose(out.numpy(), x * 10.0, rtol=1e-6)

    def test_missing_export_rejected(self, libs):
        with pytest.raises(ValueError, match="missing required export"):
            SingleShot(framework="custom-so", model=libs["bad"])
        with pytest.raises(ValueError, match="missing required export"):
            get_backend("custom-so").open(libs["bad"])

    def test_cpp_class_api(self, libs, rng):
        x = rng.standard_normal((2, 5)).astype(np.float32)
        with SingleShot(framework="custom-so", model=libs["offsetscale_ref"], custom="1.5") as s:
            (want,) = s.invoke(x)
        be, (out,) = _port_invoke(libs["offsetscale"], x, custom="1.5")
        assert be.input_spec().tensors[0].shape == (2, 5)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        np.testing.assert_allclose(out.numpy(), x * 3.0 + 1.5, rtol=1e-6)

    def test_cpp_class_api_in_pipeline(self, libs):
        data = [np.ones((2, 5), np.float32)]
        want = _pipeline(jnns, libs["offsetscale2_ref"], data, lambda d: d)
        got = _pipeline(tnns, libs["offsetscale2"], data, torch.from_numpy)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], np.full((2, 5), 3.0))

    def test_pipeline_with_frame_dropping(self, libs):
        """rc > 0 from nns_invoke drops the frame."""
        data = [np.full(4, i, np.uint8) for i in range(6)]
        want = _pipeline(jnns, libs["dropper_ref"], data, lambda d: d)
        got = _pipeline(tnns, libs["dropper"], data, torch.from_numpy)
        assert len(got) == len(want) == 3  # every second frame dropped
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[1], data[2])

    def test_wrong_dtype_or_count_refused(self, libs):
        be = get_backend("custom-so")
        be.open(libs["scaler"])
        try:
            with pytest.raises(ValueError, match="dtype"):
                be.invoke((torch.zeros(3, 4, dtype=torch.float64),))
            with pytest.raises(ValueError, match="input tensors"):
                be.invoke((torch.zeros(3, 4), torch.zeros(3, 4)))
        finally:
            be.close()

    def test_ports_header_is_the_references_abi(self):
        """The port keeps its own copy of the headers; its declarations are
        the JAX package's, line for line outside the comments."""
        import re

        ref = Path(jnns.__file__).resolve().parent / "native"

        def code(text):
            return [ln for ln in re.sub(r"/\*.*?\*/", "", text, flags=re.S).splitlines()
                    if ln.strip()]

        for name in ("nns_custom_filter.h", "nns_filter.hh"):
            assert code((HEADER_DIR / name).read_text()) == code((ref / name).read_text())

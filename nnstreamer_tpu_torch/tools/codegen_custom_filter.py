"""Custom-filter skeleton generator.

The port's counterpart of the JAX package's ``tools/codegen_custom_filter.py``
(itself the analog of NNStreamer's ``nnstreamerCodeGenCustomFilter.py``,
which emits C custom filter skeletons): it writes a ``custom-python`` filter
file that the port's backend loads::

    python -m nnstreamer_tpu_torch.tools.codegen_custom_filter my_filter \\
        --input 224:224:3 --input-type uint8 \\
        --output 1001 --output-type float32 [--torch] [-o DIR]

The file loads with ``tensor_filter framework=custom-python
model=my_filter.py`` and passes its inputs through, flattened, cut or
zero-padded and cast to each declared output, until ``invoke`` is filled
in.  The default body is numpy (the backend turns numpy outputs into
tensors); ``--torch`` writes it in torch instead, where the JAX package's
``--jax`` imports ``jax.numpy``: the outputs stay on the inputs' device.
"""

from __future__ import annotations

import argparse
import os

TEMPLATE = '''"""{name}: custom filter skeleton (generated by codegen_custom_filter.py).

Loads with: tensor_filter framework=custom-python model={name}.py
Fill in :meth:`CustomFilter.invoke`.
"""

import numpy as np
{torch_import}
from nnstreamer_tpu_torch.backends.custom import CustomFilterBase
from nnstreamer_tpu_torch.spec import TensorSpec, TensorsSpec


class CustomFilter(CustomFilterBase):
    def __init__(self, custom: str = ""):
        # the tensor_filter `custom=` property string, if any
        self.custom = custom

    def get_input_spec(self):
        return TensorsSpec(tensors=(
{in_tensors}
        ))

    def get_output_spec(self):
        return TensorsSpec(tensors=(
{out_tensors}
        ))

    def invoke(self, *tensors):
        """One frame of work: len(tensors) == {n_in}; return {n_out} tensor(s)
        matching get_output_spec()."""
        # TODO: replace this placeholder with real work.
        out_spec = self.get_output_spec()
        outs = []
        for i, t in enumerate(out_spec.tensors):
{body}
        return tuple(outs)
'''

NUMPY_BODY = '''            src = np.asarray(tensors[min(i, len(tensors) - 1)]).ravel()
            n = int(np.prod(t.shape))
            buf = np.zeros(n, dtype=t.dtype)
            buf[: min(n, src.size)] = src[: min(n, src.size)].astype(t.dtype)
            outs.append(buf.reshape(t.shape))'''

TORCH_BODY = '''            src = torch.as_tensor(tensors[min(i, len(tensors) - 1)]).reshape(-1)
            n = int(np.prod(t.shape))
            dtype = torch.from_numpy(np.zeros(0, dtype=t.dtype)).dtype
            buf = torch.zeros(n, dtype=dtype, device=src.device)
            buf[: min(n, src.numel())] = src[: min(n, src.numel())].to(dtype)
            outs.append(buf.reshape(t.shape))'''

TORCH_NOTE = "import torch\n"


def spec_lines(dims_list, types_list, indent="            "):
    lines = []
    for i, dims in enumerate(dims_list):
        dtype = types_list[i] if i < len(types_list) else types_list[-1]
        shape = ", ".join(dims.split(":"))
        lines.append(
            f"{indent}TensorSpec(dtype=np.{dtype}, shape=({shape}{',' if ':' not in dims else ''})),")
    return "\n".join(lines)


def render(name, inputs, outputs, input_types=None, output_types=None,
           use_torch=False) -> str:
    """The skeleton's source."""
    in_types = input_types or ["float32"]
    out_types = output_types or ["float32"]
    return TEMPLATE.format(
        name=name,
        torch_import=TORCH_NOTE if use_torch else "",
        in_tensors=spec_lines(inputs, in_types),
        out_tensors=spec_lines(outputs, out_types),
        n_in=len(inputs),
        n_out=len(outputs),
        body=TORCH_BODY if use_torch else NUMPY_BODY,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", help="filter name (output file: <name>.py)")
    ap.add_argument("--input", action="append", required=True,
                    help="input dims, numpy order, e.g. 224:224:3 (repeatable)")
    ap.add_argument("--input-type", action="append", default=None,
                    help="input dtype per --input (default float32)")
    ap.add_argument("--output", action="append", required=True,
                    help="output dims (repeatable)")
    ap.add_argument("--output-type", action="append", default=None,
                    help="output dtype per --output (default float32)")
    ap.add_argument("--torch", action="store_true",
                    help="write the skeleton's body in torch (outputs on the inputs' device)")
    ap.add_argument("-o", "--out-dir", default=".")
    args = ap.parse_args(argv)

    src = render(args.name, args.input, args.output, args.input_type, args.output_type,
                 use_torch=args.torch)
    path = os.path.join(args.out_dir, f"{args.name}.py")
    with open(path, "w") as f:
        f.write(src)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()

"""nnstreamer_tpu_torch: the PyTorch/CUDA port of the JAX package.

Typed tensor streams with negotiated specs, a pipeline graph of converter,
transform, filter and decoder elements, and a PyTorch model backend.  Frames
carry torch tensors; the transform and the filter compute on the card
(``device="cuda"``, the default) unless the caller passes ``device="cpu"``.
The three kernels the JAX package wrote in Pallas are hand-written CUDA
here (:mod:`nnstreamer_tpu_torch.ops.kernels`, :mod:`nnstreamer_tpu_torch.ops.nms`).

A pipeline comes from a gst-launch string (:func:`parse_launch`) or from
:meth:`Pipeline.add` / :meth:`Pipeline.link`.  ``tensor_upload ! queue``
before the filter moves the host→device copy onto the source's thread, and
on the card the filter's folded segment is captured once per negotiated
geometry as a CUDA graph and replayed per frame.
"""

# Opt-in lock-order verification (NNSTPU_LOCKDEP=1 / ini [analysis]
# lockdep): installed before the package's modules load, so the locks their
# module-level and constructor code makes are tracked from birth; a cheap env
# and conf check when off.
from .analysis.lockdep import maybe_install as _lockdep_maybe_install

_lockdep_maybe_install()

from .buffer import EOS, NONE_TS, SECOND, Event, Frame  # noqa: F401,E402
from .graph import (  # noqa: F401
    NegotiationError,
    Node,
    ParseError,
    Pipeline,
    PipelineError,
    SourceNode,
    known_elements,
    make,
    parse_launch,
    register_element,
)
from .media import AudioSpec, OctetSpec, TextSpec, VideoSpec  # noqa: F401
from .spec import (  # noqa: F401
    ANY,
    BFLOAT16,
    NNS_TENSOR_RANK_LIMIT,
    NNS_TENSOR_SIZE_LIMIT,
    TensorSpec,
    TensorsSpec,
    dtype_from_name,
    dtype_name,
    spec_of,
)

__version__ = "0.1.0"

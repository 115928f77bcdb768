"""The mesh and the in-model parallel modes: ring and Ulysses attention
(sequence), the switch MoE (experts) and GPipe (pipeline stages).  The
multi-process side (``init_distributed``, ``init_from_env``) is ROADMAP
item 13b."""

from .mesh import (  # noqa: F401
    batch_sharding,
    force_device_count,
    make_mesh,
    replicated,
)
from .ring_attention import (  # noqa: F401
    full_attention,
    ring_attention,
    sequence_sharding,
)
from .sequence import ulysses_attention  # noqa: F401

from .node import (  # noqa: F401
    NegotiationError,
    Node,
    Pad,
    SinkTerminal,
    SourceNode,
)
from .pipeline import Pipeline, PipelineError  # noqa: F401
from .registry import known_elements, make, register_element  # noqa: F401
from .parse import ParseError, parse_launch  # noqa: F401

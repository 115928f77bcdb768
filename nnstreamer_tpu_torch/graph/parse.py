"""gst-launch style pipeline strings (``gst_parse_launch``).

The port's copy of the JAX package's ``graph/parse.py``, with the same
grammar::

    pipeline   := chain (chain)*
    chain      := endpoint ('!' endpoint)*
    endpoint   := element | padref
    element    := TYPE (KEY=VALUE)*
    padref     := NAME '.' [PADNAME]       # reference to a named element

Keys take dashes or underscores (``num-buffers`` is ``num_buffers``), and
``name=`` names the element.  Values reach the element's constructor as
strings.  Example, the canonical image-labeling topology::

    videotestsrc num-buffers=64 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
        tensor_upload ! queue max-size-buffers=16 !
        tensor_filter framework=torch name=f ! tensor_sink name=out

:func:`linear_chain` and :func:`split_launch` read and cut a linear
``a ! b ! c`` chain for the partitioner, as in the JAX package.
"""

from __future__ import annotations

import shlex
from typing import Dict, List, Optional, Tuple

from . import registry
from .node import Node
from .pipeline import Pipeline


class ParseError(Exception):
    pass


def _tokenize(description: str) -> List[str]:
    lex = shlex.shlex(description, posix=True)
    lex.whitespace_split = True
    lex.commenters = ""
    return list(lex)


def parse_launch(description: str, pipeline: Optional[Pipeline] = None) -> Pipeline:
    """Build a :class:`Pipeline` from a launch string."""
    pipe = pipeline or Pipeline()
    tokens = _tokenize(description)
    i = 0
    last: Optional[Tuple[Node, Optional[str]]] = None  # (node, src pad name)
    pending_link = False
    auto_idx = 0

    def is_padref(tok: str) -> bool:
        head = tok.split(".", 1)[0]
        return "." in tok and head in pipe.nodes and "=" not in tok

    while i < len(tokens):
        tok = tokens[i]
        if tok == "!":
            if last is None:
                raise ParseError(f"dangling '!' in {description!r}")
            pending_link = True
            i += 1
            continue

        if is_padref(tok):
            name, _, pad = tok.partition(".")
            node = pipe.nodes[name]
            pad = pad or None
            if pending_link:
                # "... ! name." links into the named element's sink pad
                src_node, src_pad = last
                src_node.get_src_pad(src_pad).link(node.get_sink_pad(pad))
                pending_link = False
                last = None  # the chain ends at a named sink reference
            else:
                # a chain that starts at a named element's src pad: "t. ! ..."
                last = (node, pad)
            i += 1
            continue

        # an element: TYPE key=value key=value ...
        etype = tok
        props: Dict[str, str] = {}
        i += 1
        while i < len(tokens) and "=" in tokens[i] and tokens[i] != "!" \
                and not is_padref(tokens[i]):
            key, _, value = tokens[i].partition("=")
            props[key.replace("-", "_")] = value
            i += 1
        name = props.pop("name", None)
        try:
            node = registry.make(etype, element_name=name, **props)
        except TypeError as exc:
            raise ParseError(f"bad properties for {etype}: {exc}") from exc
        if node.name in pipe.nodes:
            if name is not None:
                raise ParseError(f"duplicate element name {node.name!r}")
            while f"{etype}{auto_idx}" in pipe.nodes:
                auto_idx += 1
            node.name = f"{etype}{auto_idx}"
        pipe.add(node)
        if pending_link:
            src_node, src_pad = last
            src_node.get_src_pad(src_pad).link(node.get_sink_pad(None))
            pending_link = False
        last = (node, None)

    if pending_link:
        raise ParseError(f"trailing '!' in {description!r}")
    return pipe


def linear_chain(description: str) -> List[Tuple[str, Dict[str, str]]]:
    """Parse ``description`` as one linear ``a ! b ! c`` chain; the ordered
    ``(etype, props)`` list (``name=`` kept in props).  Pad references and
    unlinked chains raise :class:`ParseError`: a cut through them would be
    ambiguous."""
    tokens = _tokenize(description)
    elements: List[Tuple[str, Dict[str, str]]] = []
    i = 0
    expect_element = True
    while i < len(tokens):
        tok = tokens[i]
        if tok == "!":
            if expect_element:
                raise ParseError(f"dangling '!' in {description!r}")
            expect_element = True
            i += 1
            continue
        if not expect_element:
            raise ParseError(
                f"non-linear pipeline (unlinked segment at {tok!r}): "
                "partitioning needs a single a ! b ! c chain"
            )
        if "." in tok and "=" not in tok:
            raise ParseError(f"pad reference {tok!r}: partitioning needs a linear chain")
        etype = tok
        props: Dict[str, str] = {}
        i += 1
        while i < len(tokens) and "=" in tokens[i] and tokens[i] != "!":
            key, _, value = tokens[i].partition("=")
            props[key] = value
            i += 1
        elements.append((etype, props))
        expect_element = False
    if expect_element and elements:
        raise ParseError(f"trailing '!' in {description!r}")
    if not elements:
        raise ParseError("empty pipeline description")
    return elements


def _render_chain(elements: List[Tuple[str, Dict[str, str]]]) -> str:
    parts = []
    for etype, props in elements:
        toks = [etype]
        for key, value in props.items():
            toks.append(f"{key}={shlex.quote(str(value))}")
        parts.append(" ".join(toks))
    return " ! ".join(parts)


def split_launch(
    description: str,
    cut: int,
    client_props: Optional[Dict[str, str]] = None,
) -> Tuple[str, str]:
    """Split a linear launch string at element boundary ``cut`` into
    ``(client_desc, server_desc)``: the client keeps elements ``[0, cut)``,
    then a ``tensor_query_client`` (with ``client_props``), then the last
    element (the sink); the server runs elements ``[cut, n-1)``.  Valid
    cuts are ``1 <= cut <= n-2``."""
    elements = linear_chain(description)
    n = len(elements)
    if n < 3:
        raise ParseError(
            f"cannot split a {n}-element chain: need source, at least "
            "one offloadable stage, and a sink"
        )
    if not 1 <= cut <= n - 2:
        raise ParseError(f"cut {cut} out of range for {n}-element chain (valid: 1..{n - 2})")
    client_elems = list(elements[:cut])
    client_elems.append(("tensor_query_client", dict(client_props or {})))
    client_elems.append(elements[n - 1])
    return _render_chain(client_elems), _render_chain(list(elements[cut:n - 1]))

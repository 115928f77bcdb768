"""Property-value parsing shared by the elements.

``parse_launch`` hands every property over as a string; built in Python,
the same element takes a real bool.  :func:`parse_bool` is the one rule for
both, with the JAX package's spellings.
"""

from __future__ import annotations

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def parse_bool(value, *, name: str = "property") -> bool:
    """A bool or string property as a bool; an unknown spelling raises (a
    mistyped ``sync=ture`` must not quietly mean False)."""
    if isinstance(value, str):
        low = value.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"bad boolean for {name}: {value!r}")
    return bool(value)

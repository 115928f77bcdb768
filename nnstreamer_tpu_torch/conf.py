"""Runtime configuration: the JAX package's ``conf.py`` lookup, cut down.

A knob ``[section] key`` is looked up in this order:

1. the env var ``NNSTPU_<SECTION>_<KEY>`` (e.g. ``NNSTPU_SEGMENT_ENABLED``);
2. an ini file (``configparser`` flavor) at ``$NNSTPU_CONF``, when set;
3. the defaults below.

Env vars and the ini file are read at each lookup, so a knob set after
import still counts.  Only ``[segment] enabled`` is ported: whole-segment
compilation (``graph/segments.py``).  The JAX package's ``[segment]
pallas_nms`` is not: fused segments here always call the NMS kernel's
wrapper, which runs the plain version on CPU tensors.
"""

from __future__ import annotations

import configparser
import os
from typing import Dict, Optional

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}

DEFAULTS: Dict[str, Dict[str, str]] = {
    "segment": {
        "enabled": "false",  # plan and fold segments in Pipeline.start (a
                             # pipeline's segment_compile attr overrides it)
    },
}


class Conf:
    """Layered configuration: env > ini file > defaults."""

    def __init__(self, environ=None):
        self._environ = environ if environ is not None else os.environ

    def _ini(self) -> configparser.ConfigParser:
        parser = configparser.ConfigParser()
        path = self._environ.get("NNSTPU_CONF")
        if path and os.path.isfile(path):
            parser.read(path)
        return parser

    def get(self, section: str, key: str, default: Optional[str] = None) -> Optional[str]:
        val = self._environ.get(f"NNSTPU_{section.upper()}_{key.upper()}")
        if val is not None:
            return val
        ini = self._ini()
        if ini.has_option(section, key):
            return ini.get(section, key)
        val = DEFAULTS.get(section, {}).get(key)
        return val if val is not None else default

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        val = self.get(section, key)
        if val is None or val == "":
            return default
        low = val.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"[{section}] {key}: not a boolean: {val!r}")


conf = Conf()

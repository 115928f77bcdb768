"""The frame queue's status codes.

The JAX package keeps a C++ frame queue here (built with ``g++`` and bound
with ctypes), with a pure-Python twin; the port has only the twin for now
(:mod:`.queue`).  The codes are the C++ queue's, so a later native queue
drops in behind the same surface.
"""

OK = 0
OK_DROPPED_OLDEST = 1
DROPPED_INCOMING = 2
SHUTDOWN = -1
TIMEOUT = -2

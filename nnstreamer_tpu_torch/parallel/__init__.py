"""Attention over a whole sequence on one device (:func:`full_attention`).

The JAX package's ``parallel/`` also shards sequences, heads, experts and
pipeline stages over a mesh (ring and Ulysses attention, MoE, GPipe); the
port takes those with the mesh, ROADMAP item 13.
"""

from .ring_attention import full_attention  # noqa: F401

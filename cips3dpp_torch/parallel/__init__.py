"""Host-to-device input pipelining (`prefetch.py`). The data-parallel mesh
of the JAX package (`parallel/mesh.py`) is not ported (ROADMAP queue 1)."""

from .prefetch import prefetch_to_device

__all__ = ["prefetch_to_device"]

"""Hot-path ops of the front end: the moment reductions and the window
gather in plain JAX, and the LM window solve as a Pallas kernel."""

from .segment_moments import segment_moments  # noqa: F401

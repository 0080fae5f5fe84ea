"""Runtime primitives.  ``retry`` is a copy of ``repro.runtime.fault``'s;
``repro.runtime.elastic`` builds JAX meshes and waits for the port's
``torch.distributed`` meshes (ROADMAP Queue 1 item 7)."""
from repro_torch.runtime.fault import retry  # noqa: F401

"""Runtime primitives, as ``repro.runtime``: ``retry`` (``fault``) and
the elastic remesh plan (``elastic``)."""
from repro_torch.runtime.elastic import remesh_shardings  # noqa: F401
from repro_torch.runtime.fault import retry  # noqa: F401

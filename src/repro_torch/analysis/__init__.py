"""Static concurrency-invariant analysis for the port's ingestion core
(``repro.analysis`` on the port's side).

``feedlint`` (repro_torch.analysis.feedlint) is a custom ``ast``-based
analyzer that machine-checks the lock discipline the concurrent core
relies on: guarded-field access, the inter-module lock acquisition
order, no blocking work (file I/O, host-device copies and
synchronisation, kernel launches) under a lock, epoch-fenced conditional
storage writes, listener callbacks fired outside the write lock, and
telemetry published outside strict locks.  The annotation grammar and
the canonical lock hierarchy live in repro_torch.analysis.annotations.

Run it as::

    python -m repro_torch.analysis.feedlint src/repro_torch

A clean tree exits 0.
"""

from repro_torch.analysis.annotations import (  # noqa: F401
    LOCK_ORDER, guarded_by)

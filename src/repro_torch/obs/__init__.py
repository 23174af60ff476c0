"""Observability for the port.  Only the snapshot-schema module is ported
so far (:mod:`.schema`, which shapes ``Platform.stats()``); the metrics
registry, tracer and SLO engine are later slices (``ROADMAP.md``: the obs
and resilience work), and the port's ``Platform`` rejects a non-``None`` ``obs=``
bundle until they land.
"""

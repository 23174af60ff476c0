"""Observability for the port.  Only the snapshot-schema module is ported
so far (:mod:`.schema`, which shapes ``Platform.stats()``); the metrics
registry, tracer and SLO engine are later slices (``ROADMAP.md``, Queue 1
item 6), and the port's ``Platform`` rejects a non-``None`` ``obs=``
bundle until they land.
"""

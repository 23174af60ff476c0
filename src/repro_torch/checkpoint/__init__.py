"""Checkpoints of the port's train state (:mod:`.manager`)."""

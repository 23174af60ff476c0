"""The synthetic, seeded data pipeline (:mod:`.pipeline`, a copy of the
JAX package's)."""

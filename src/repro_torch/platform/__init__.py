"""``repro.platform`` — the unified facade over the whole aAPP stack."""
from .facade import Platform

__all__ = ["Platform"]

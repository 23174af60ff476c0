"""--arch gemma3-4b : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["gemma3-4b"]


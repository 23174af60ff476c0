"""--arch starcoder2-15b : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["starcoder2-15b"]


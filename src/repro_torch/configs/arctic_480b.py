"""--arch arctic-480b : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["arctic-480b"]


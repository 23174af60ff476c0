"""--arch internvl2-76b : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["internvl2-76b"]


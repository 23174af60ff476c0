"""--arch falcon-mamba-7b : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["falcon-mamba-7b"]


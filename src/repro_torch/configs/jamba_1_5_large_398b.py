"""--arch jamba-1.5-large-398b : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["jamba-1.5-large-398b"]


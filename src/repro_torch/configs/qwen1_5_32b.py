"""--arch qwen1.5-32b : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["qwen1.5-32b"]


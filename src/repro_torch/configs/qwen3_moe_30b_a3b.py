"""--arch qwen3-moe-30b-a3b : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["qwen3-moe-30b-a3b"]


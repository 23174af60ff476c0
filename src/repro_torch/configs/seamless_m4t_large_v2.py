"""--arch seamless-m4t-large-v2 : re-exports the registry config (one file per assigned arch)."""
from .registry import ARCHS

CONFIG = ARCHS["seamless-m4t-large-v2"]


"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of the checkout (the ``cuda`` ones need an NVIDIA GPU and skip
without one).  The checkout's root and ``src`` go on the path, so that
``bench.*`` and the port import as the harness imports them."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

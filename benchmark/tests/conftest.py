"""The benchmark's own tests: the checkout's root on sys.path, so that
``benchmark`` and the port import as they do under ``python3 -m``."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

"""The harness's tests import the port from ``src/`` and the harness from the
repository root, as ``run.py`` does; they import no JAX."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

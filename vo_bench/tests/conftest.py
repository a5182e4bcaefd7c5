"""The benchmark's own tests: its folder and the checkout on the import path."""

import os
import sys

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (_BENCH, os.path.dirname(_BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)

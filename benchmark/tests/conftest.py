"""The benchmark's tests import its library and the port from the checkout."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

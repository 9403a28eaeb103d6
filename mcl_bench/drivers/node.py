"""The default driver: the port's ``MCLNode`` driven in replay or live
mode (``generator.py``), held against the single-filter reference
(``check.py``). A mix that needs another driver (a fleet, a trace made
from the seed) names a file of its own here under ``driver``; it exposes
a ``Session`` and a ``Comparison`` with the same methods."""

from mcl_bench.check import Comparison
from mcl_bench.generator import Session

__all__ = ["Comparison", "Session"]

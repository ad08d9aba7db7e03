"""Per-layer metrics, one module each.  A module names its ``UNIT``,
``LAYER`` (as PERF.md's list of layers has it), ``MOVES`` (the end-to-end
metric it should move) and ``SOURCE``, and ``read(r)`` takes the number
from the run's :class:`xbench.cell.Readings`, or returns None where there
is nothing to read."""

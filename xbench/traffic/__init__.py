"""Load generation: :class:`pool.PoolSource`, driven by the mix files
``xbench/traffic/<traffic>.json``."""

"""Device-mesh programs of the port (``parallel/mesh.py``)."""

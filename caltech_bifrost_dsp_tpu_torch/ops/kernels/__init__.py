"""Hand-written CUDA kernels (``csrc/``) and their build.

Nothing here compiles or loads at import: :func:`._build.library` builds
the shared library with ``nvcc`` at first use.
"""

"""PyTorch/CUDA port of the distributed multidimensional FFT (``repro``).

Mirrors ``src/repro/``: ``core/`` holds the plan and its modules, and
``kernels/<name>/{ref,kernel,ops}.py`` the hand-written CUDA kernels beside
their plain torch versions.  Imports torch, never jax or ``repro``.
"""

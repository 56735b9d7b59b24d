"""Four-step DFT kernel (``impl="matmul"``): see :mod:`.ops`."""

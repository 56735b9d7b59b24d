"""Tiled local transpose (K5), ``(A, B, C) -> (B, A, C)``: see :mod:`.ops`."""

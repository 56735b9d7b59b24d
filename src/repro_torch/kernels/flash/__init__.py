"""Causal flash attention (K6): see :mod:`.ops`."""

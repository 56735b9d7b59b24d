"""Exchange codec kernels (``exchange_impl="cuda"``): see :mod:`.ops`."""

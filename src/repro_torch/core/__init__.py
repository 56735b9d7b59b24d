"""Plan modules of the port: decomposition, pencils, transforms, exchanges
and the ``ParallelFFT`` plan."""

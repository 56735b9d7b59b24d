"""Torch twins of the reference's ``examples/`` scripts, each a module with a
``main()`` for ``torchrun ... -m repro_torch.examples.<name>``:
:mod:`.quickstart`, :mod:`.poisson` and :mod:`.navier_stokes`."""

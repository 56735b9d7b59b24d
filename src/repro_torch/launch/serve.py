"""Deprecated alias: ``repro_torch.launch.serve`` → :mod:`repro_torch.launch.serve_lm`.

The LM demo server is ``serve_lm``, so that ``python -m repro_torch.serve``
is unambiguously the spectral FFT serving engine (:mod:`repro_torch.serve`),
as in the reference.  Importing this stub gives the renamed module's
surface plus a DeprecationWarning.
"""

from __future__ import annotations

import warnings

from repro_torch.launch.serve_lm import *  # noqa: F401,F403 - re-export the surface
from repro_torch.launch.serve_lm import main  # noqa: F401 - explicit for -m use

warnings.warn(
    "repro_torch.launch.serve was renamed to repro_torch.launch.serve_lm "
    "(python -m repro_torch.serve is the spectral FFT serving engine); "
    "this alias will be removed in a future release",
    DeprecationWarning, stacklevel=2)

if __name__ == "__main__":
    raise SystemExit(main())

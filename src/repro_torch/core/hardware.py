"""The card's constants the analytic time model prices a plan at.

:meth:`repro_torch.core.pfft.ParallelFFT.model_time_s`,
:func:`repro_torch.core.redistribute.exchange_time_model` and
:data:`repro_torch.core.modelfit.REFERENCE_COEFFS` default to these.  Each
was measured by the ``coeffs`` phase of ``chip_smoke.py`` (its
``{"coeffs"}`` line: the median of 7 rounds, their least and greatest
beside it) in two runs on the card named in :data:`CARD`, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it,
except :data:`ICI_BW`, which one card cannot measure.  Each comment gives
the two runs' medians and how far apart they lie.
"""

#: the card and power limit the measured constants below come from
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

#: bytes/s of HBM: a device-to-device copy of a 1 GiB complex64 block, its
#: read and its write counted (``cuda_ms``: 0.7123 / 0.7125 ms, 3.0147e12 /
#: 3.0141e12 B/s, 0.02 % apart)
HBM_BW = 3.014e12

#: flop/s of the local FFT: ``torch.fft.fft`` on 262144 rows of n = 512,
#: counted 5 n log2 n a row as ``ParallelFFT._stage_flops_at`` counts
#: (6.040e9 flop in 0.7183 / 0.7183 ms, 8.4082e12 / 8.4089e12 flop/s,
#: 0.01 % apart)
PEAK_FLOPS = 8.408e12

#: seconds of fixed cost a collective: the device time of one
#: ``all_to_all_single`` of 4 KiB on a 1-rank NCCL group (``cuda_ms``, the
#: calls queued behind a spin: 1.953 / 1.992 µs, 2 % apart).  The host's
#: enqueue of one such call (55 µs to 295 µs, medians 63 and 222 µs) is not
#: in it: it does not repeat between processes.  A collective across cards
#: is not measured.
ICI_LATENCY_S = 1.97e-6

#: bytes/s a direction between cards: NVLink 4 from NVIDIA's data sheet,
#: unmeasured (one card: every exchange has M = 1)
ICI_BW = 450e9

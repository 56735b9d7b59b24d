"""Audits of the port's plans (the port of ``repro/analysis``): :mod:`.planlint`."""

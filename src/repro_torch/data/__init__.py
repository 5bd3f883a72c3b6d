"""Data pipeline (counterpart of :mod:`repro.data`)."""

"""Optimizers (counterpart of :mod:`repro.optim`)."""

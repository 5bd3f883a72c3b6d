"""Runtime transforms (counterpart of :mod:`repro.runtime`): int8
error-feedback compression."""

"""Optimizers (port of `repro.optim`)."""

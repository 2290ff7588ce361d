"""Optimizers, data pipeline and the M-worker train step."""

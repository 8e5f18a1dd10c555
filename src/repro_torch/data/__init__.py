"""Synthetic datasets (a numpy-only copy of ``repro.data``)."""

"""Synthetic inputs (numpy) for examples, tests and chip_smoke.py."""

"""Parallel context for the port (one card: tp = dp = 1)."""

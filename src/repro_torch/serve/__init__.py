"""Serving: the batched decode engine."""

"""Fused compute-collective operators."""

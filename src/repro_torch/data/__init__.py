"""Synthetic data generators and the input pipeline."""

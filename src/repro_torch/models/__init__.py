"""Model code: plain functions on tensors, parameters in dicts."""

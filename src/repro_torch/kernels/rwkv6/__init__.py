"""Chunked WKV6 recurrence (CUDA kernel + plain versions)."""

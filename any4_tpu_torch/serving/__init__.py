"""Paged and contiguous KV pools and the continuous-batching engine."""

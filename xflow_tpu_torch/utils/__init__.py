"""Shared helpers: the clamped sigmoid, row-range shard reads."""

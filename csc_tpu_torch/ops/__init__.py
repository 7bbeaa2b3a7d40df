"""Batched device pipelines: the plain K1 version, its kernel wrapper and
the decode pipeline."""

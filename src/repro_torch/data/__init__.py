"""Deterministic training data sources."""

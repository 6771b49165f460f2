"""Distributed-training pieces the single-card train step uses."""

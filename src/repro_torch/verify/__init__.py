"""Bitwise state digests and per-step digest chains."""

"""Optimizer and train step over plain parameter dicts."""

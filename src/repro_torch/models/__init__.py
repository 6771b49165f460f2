"""Model code over plain parameter dicts in the JAX weight layout."""

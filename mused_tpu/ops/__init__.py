"""Device algorithm library (JAX/XLA)."""

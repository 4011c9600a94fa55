"""Device compute ops (JAX/XLA): smoothing pipeline, linear algebra, graphs."""

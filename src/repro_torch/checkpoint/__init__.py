"""Simulated durable storage of the fabric (copy of the JAX package's SimFS)."""

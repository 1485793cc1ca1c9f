"""Persistence-instruction accounting (copy of the JAX package's ``nvm``)."""

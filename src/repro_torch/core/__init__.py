"""Structures and their vectorized combines (counterpart of ``repro.core``)."""

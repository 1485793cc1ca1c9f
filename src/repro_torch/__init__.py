"""PyTorch + CUDA port of the detectable flat-combining fabric.

Mirrors the layout of the JAX package ``repro`` module for module, so a
reader finds each counterpart under the same path.  The port imports
``torch`` and numpy only: nothing of JAX and nothing of ``repro``.  Entry
points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); they never move to the CPU on their own.
"""

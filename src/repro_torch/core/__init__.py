"""Structures and their vectorized combines (``torch_dfc``), and the paper's
host-level detectable objects over the simulated NVM (``dfc``,
``dfc_queue``, ``dfc_deque``, ``sim``, ``linearize``, ``harness``,
``baselines``): the counterpart of ``repro.core``."""

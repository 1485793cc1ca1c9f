"""Entry points that drive the fabric (counterpart of ``repro.launch``)."""

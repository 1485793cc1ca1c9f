"""Model families served through the fabric (counterpart of ``repro.models``)."""

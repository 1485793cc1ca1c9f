"""The sharded durable combining fabric (counterpart of ``repro.runtime``)."""

"""The deterministic, resumable data pipeline (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import DataPipeline

__all__ = ["DataPipeline"]

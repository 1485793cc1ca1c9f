"""Gradient compression and elastic resizing (counterpart of
``repro.distributed``)."""

from repro_torch.distributed.compression import (
    CompressionState,
    compress_topk,
    decompress_topk,
    dequantize_int8,
    ef_compress_grads,
    init_compression,
    quantize_int8,
)
from repro_torch.distributed.elastic import ElasticPlan, plan_resize

__all__ = [
    "CompressionState",
    "compress_topk",
    "decompress_topk",
    "ef_compress_grads",
    "init_compression",
    "quantize_int8",
    "dequantize_int8",
    "ElasticPlan",
    "plan_resize",
]

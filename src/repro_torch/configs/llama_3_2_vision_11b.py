"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer (8 total).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend (ViT) is a stub per the assignment: ``input_specs``
provides precomputed patch embeddings (B, n_img_tokens, d_model).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=128256,
        cross_attn_every=5,
        n_img_tokens=1024,
        rope_theta=500_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke",
        family="vlm",
        n_layers=10,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        cross_attn_every=5,
        n_img_tokens=16,
        remat="none",
        dtype="float32",
    )

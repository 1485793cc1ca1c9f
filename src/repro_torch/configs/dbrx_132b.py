"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) expert d_ff=10752
vocab=100352; 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base;
unverified]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        n_experts=16,
        top_k=4,
        moe_dff=10752,
        rope_theta=500_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        n_experts=4,
        top_k=2,
        moe_dff=128,
        remat="none",
        dtype="float32",
    )

"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) expert d_ff=4864
vocab=32000; MoE 128 experts top-2 **plus a dense residual MLP** evaluated in
parallel (Snowflake Arctic's dense-MoE hybrid).
[hf:Snowflake/snowflake-arctic-base; hf]

About 477 B parameters (the reference's count), about 0.95 TB of bf16: no
single card holds it, so a one-card run cuts the depth and keeps every width.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,  # dense residual MLP width
        vocab=32000,
        n_experts=128,
        top_k=2,
        moe_dff=4864,
        dense_residual=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        n_experts=8,
        top_k=2,
        moe_dff=96,
        dense_residual=True,
        remat="none",
        dtype="float32",
    )

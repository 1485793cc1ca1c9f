"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152,
llama-arch small, tied embeddings.  [hf:HuggingFaceTB/SmolLM-135M; hf]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab=49152,
        tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke",
        family="dense",
        n_layers=4,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_ff=96,
        vocab=256,
        tie_embeddings=True,
        remat="none",
        dtype="float32",
    )

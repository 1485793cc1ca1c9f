"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048; decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Backbone only per the assignment: the EnCodec frontend + codebook delay
pattern are stubbed — ``input_specs`` provides precomputed frame embeddings
(B, S, d_model); logits are over the 2048-entry codebook.  MusicGen's
parametric LayerNorm is mapped to RMSNorm (see DESIGN.md).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=2048,
        embedding_inputs=True,
        mlp="gelu",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke",
        family="audio",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=64,
        embedding_inputs=True,
        mlp="gelu",
        remat="none",
        dtype="float32",
    )

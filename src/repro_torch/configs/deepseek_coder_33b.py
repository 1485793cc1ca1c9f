"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256; llama-arch.  [arXiv:2401.14196; hf]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab=32256,
        rope_theta=100_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke",
        family="dense",
        n_layers=4,
        d_model=56,
        n_heads=7,
        n_kv_heads=1,
        d_ff=144,
        vocab=256,
        remat="none",
        dtype="float32",
    )

"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16; mamba1 architecture.  [arXiv:2410.05355; unverified]

d_inner = 2*4096 = 8192, d_conv = 4, dt_rank = 256.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=65024,
        ssm_version=1,
        ssm_state=16,
        d_conv=4,
        expand=2,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=256,
        ssm_version=1,
        ssm_state=4,
        d_conv=4,
        expand=2,
        remat="none",
        dtype="float32",
    )

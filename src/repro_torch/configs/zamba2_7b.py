"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

Structure: 13 groups of 6 mamba2 layers, the single *shared* attention+MLP
block (32 heads of 112, d_ff 14336) applied after each group, + a 3-layer
mamba tail (13*6 + 3 = 81).  As in the JAX package, zamba2's
concatenated-embedding input to the shared block and its LoRA adapters are
simplified away: the shared block is a plain pre-norm attention + SwiGLU
block that reads the residual stream alone, with one set of weights for all
13 applications.  Runs ``long_500k`` with a 4096-token rolling window on the
shared attention (its Mamba state is O(1)).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab=32000,
        ssm_version=2,
        ssm_state=64,
        ssm_head_dim=64,
        expand=2,
        attn_every=6,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm_version=2,
        ssm_state=16,
        ssm_head_dim=16,
        expand=2,
        attn_every=2,
        remat="none",
        dtype="float32",
    )

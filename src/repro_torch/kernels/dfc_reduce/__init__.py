"""The four per-shard combine kernels, their plain versions and the combine steps."""

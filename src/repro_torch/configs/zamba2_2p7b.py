"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_head=80
d_ff=10240 vocab=32000, ssm_state=64: Mamba-2 backbone + one SHARED
attention+MLP block applied every 6th layer.  [arXiv:2411.15242; hf]
(copy of ``repro.configs.zamba2_2p7b``)
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_version=2,
    ssm_expand=2,
    attn_every=6,
    shared_attn=True,
    long_context="native",
    window=4096,
)

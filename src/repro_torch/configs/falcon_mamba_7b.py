"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free, vocab=65024,
ssm_state=16 (Mamba-1 architecture).  [arXiv:2410.05355; unverified]
(copy of ``repro.configs.falcon_mamba_7b``)

long_500k runs natively: SSM state is O(1) in sequence length.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_version=1,
    ssm_expand=2,
    long_context="native",
)

"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.  [arXiv:2407.21783; unverified]
(copy of ``repro.configs.llama3_8b``)
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    long_context="skip",
    rope_theta=500000.0,
)

"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k context.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]
(copy of ``repro.configs.mistral_nemo_12b``)
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    long_context="skip",
    rope_theta=1000000.0,
)

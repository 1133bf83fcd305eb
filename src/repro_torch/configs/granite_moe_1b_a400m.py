"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
(copy of ``repro.configs.granite_moe_1b_a400m``)

About 1.39e9 parameters (1.21e9 of them in the experts): at bf16 with
float32 AdamW moments it serves and trains on one 80 GB card at full
width and depth.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    moe_every=1,
    capacity_factor=1.25,
    long_context="skip",
    rope_theta=10000.0,
)

"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
(copy of ``repro.configs.llama4_maverick_400b_a17b``)

MoE layers interleave every 2nd layer (this is what makes the totals match
the name: 24 x 128 experts x 3*5120*8192 ~= 386B expert params + dense ~=
400B total, ~17B active with top-1).

At full width the model holds about 4e11 parameters, 0.8 TB in bf16: it
does not fit one 80 GB card.  One repeat of its pattern at full width
(``dataclasses.replace(CONFIG, n_layers=CONFIG.pattern_period())``: a
dense layer and an MoE layer of 128 experts, about 1.84e10 parameters,
36.9 GB in bf16) does, and serves on one card; the whole model waits for
experts sharded across cards (``models/sharding.py``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    moe_every=2,
    capacity_factor=1.25,
    long_context="skip",
    rope_theta=500000.0,
)

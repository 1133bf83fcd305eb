"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion VQ image tokens.  [arXiv:2405.09818; unverified]
(copy of ``repro.configs.chameleon_34b``)

Modality note (the reference's DESIGN.md §4): the VQ image tokenizer is a
STUB — images are already token ids inside the unified 65536 vocab, so the
backbone consumes a plain token stream (``input_specs()`` provides token
ids).  The norm comment below is the reference's: neither package applies
a qk-norm.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab_size=65536,
    norm="layernorm",        # chameleon uses qk-norm + layernorm placement
    long_context="skip",
    frontend="vq_tokens",
    rope_theta=10000.0,
)

"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16: full MHA) d_ff=4096
vocab=51865; encoder-decoder with conv frontend STUB.  [arXiv:2212.04356]
(copy of ``repro.configs.whisper_medium``)

The conv1d audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings [B, S, d_model].  A shape's seq_len applies
to the encoder's frame axis (1500 frames for whisper's 30-second window);
the decoder runs its own token axis, up to ``max_target_len``.  GELU MLP,
LayerNorm, sinusoidal positions (no RoPE), tied embeddings.  About
7.6e8 parameters: at bf16 with float32 AdamW moments it serves and trains
on one 80 GB card at full width and depth.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,              # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    max_target_len=448,
    long_context="skip",
    frontend="audio_frames",
)

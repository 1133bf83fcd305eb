"""Language-model stack: parameter specs, layers, attention, the MLP,
MoE and selective-SSM blocks, the decoder, the whisper encoder-decoder
and the ``lm`` entry points, mirroring ``repro.models``."""

from repro_torch.models import (
    attention,
    layers,
    lm,
    mlp,
    moe,
    spec,
    ssm,
    transformer,
    whisper,
)

__all__ = [
    "attention", "layers", "lm", "mlp", "moe", "spec", "ssm",
    "transformer", "whisper",
]

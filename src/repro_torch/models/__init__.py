"""Language-model stack (serving path): parameter specs, layers,
attention, selective-SSM blocks, the decoder and the ``lm`` entry
points, mirroring ``repro.models``."""

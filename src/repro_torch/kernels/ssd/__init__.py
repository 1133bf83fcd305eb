"""Chunk-parallel SSD scan: Mamba-2's recurrence with a per-head scalar
decay, closed within each chunk into products with a decay matrix, the
state carried between chunks."""

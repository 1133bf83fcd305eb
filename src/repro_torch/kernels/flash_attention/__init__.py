"""Flash attention: grouped-query attention with an online softmax
(causal mask with ``q_offset``, key-length mask, f32 accumulation)."""

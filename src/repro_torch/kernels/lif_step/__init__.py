"""LIF step kernel: one elementwise leaky integrate-and-fire update."""

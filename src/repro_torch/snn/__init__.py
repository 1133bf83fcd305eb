"""Spiking-network layer: neurons, crossbar and the multi-chip network."""

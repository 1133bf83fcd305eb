"""Bucket-pack kernel: stable FIFO packing of wire words into bucket rows."""

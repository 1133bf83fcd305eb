"""Merge-sort kernels: stable counting sorts of the merge stage (wire
words by wrap key in one pass over 257 bins, and structure-of-arrays
lanes by deadline in radix passes over the key bits that vary)."""

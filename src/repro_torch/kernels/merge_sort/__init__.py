"""Merge-sort kernels: stable bitonic sorts of the merge stage (wire
words by wrap key, and structure-of-arrays lanes by deadline)."""

"""Merge-state layout and the merge apply / compact kernels."""

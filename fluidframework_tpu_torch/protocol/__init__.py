"""Protocol constants shared by the port's kernels and service."""

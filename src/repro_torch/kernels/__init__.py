"""The port's kernels layer (counterpart: the reference package's kernels/)."""

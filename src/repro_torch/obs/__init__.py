"""The port's obs layer (counterpart: the reference package's obs/)."""

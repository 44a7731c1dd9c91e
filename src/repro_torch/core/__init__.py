"""The port's core layer (counterpart: the reference package's core/)."""

"""The port's training layer (counterpart: the reference package's training/)."""

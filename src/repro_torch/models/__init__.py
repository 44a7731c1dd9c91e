"""The port's models layer (counterpart: the reference package's models/)."""

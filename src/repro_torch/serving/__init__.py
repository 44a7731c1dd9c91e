"""The port's serving layer (counterpart: the reference package's serving/)."""

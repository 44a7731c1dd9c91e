"""The port's data layer (counterpart: the reference package's data/)."""

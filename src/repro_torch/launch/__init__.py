"""The port's launch layer (counterpart: the reference package's launch/)."""

"""The port's plane-contract analyzer: the stage-protocol pass over the
drivers named by ``repro_torch.core.plane_contract`` (``python -m
repro_torch.analysis.run``)."""

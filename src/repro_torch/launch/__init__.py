"""Launchers (port of ``repro.launch``): the autoscaled serving endpoint."""

"""Serving (port of ``repro.serve``): the continuous-batching engine."""

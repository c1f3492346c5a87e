"""Evaluation: episode metrics and REI over tensors."""

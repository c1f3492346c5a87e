"""Synthetic trace generation."""

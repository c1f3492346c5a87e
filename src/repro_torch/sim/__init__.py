"""Cluster plant simulator and the NumPy metrics oracle."""

"""Solvers built on the port's engines."""

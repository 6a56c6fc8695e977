"""Measurement scripts of the port, run as modules (python -m ...)."""

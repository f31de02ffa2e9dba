"""Vocoder wrappers of the port."""

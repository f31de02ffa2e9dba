"""Importers of the reference's PyTorch checkpoints."""

"""Deterministic data for the port (``TokenDataset``)."""

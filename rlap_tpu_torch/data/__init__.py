"""Synthetic datasets and the dataset loaders."""

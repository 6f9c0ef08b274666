"""Corpus manifests, sources with the train/test split, sampling,
collation and the batch loaders."""

"""Input pipeline: sharded datasets and device prefetch."""

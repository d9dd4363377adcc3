"""Data: dataset ingest and batch iteration."""

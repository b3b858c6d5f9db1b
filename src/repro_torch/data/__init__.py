"""Real-data front door: out-of-core edge-list ingestion (``ingest``)."""
from .ingest import IngestedGraph, ingest_edges, load_ingested

__all__ = ["IngestedGraph", "ingest_edges", "load_ingested"]

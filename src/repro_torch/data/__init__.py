"""The data layer: out-of-core edge-list ingestion (``ingest``), the
token pipeline (``pipeline``) and the PBNG → LM curriculum
(``graph_data``), exported as the JAX package's ``repro.data``."""
from .pipeline import DataConfig, memmap_batches, synthetic_batches
from .graph_data import curriculum_sequences, sequence_batches
from .ingest import IngestedGraph, ingest_edges, load_ingested

__all__ = [
    "DataConfig",
    "IngestedGraph",
    "ingest_edges",
    "load_ingested",
    "memmap_batches",
    "synthetic_batches",
    "curriculum_sequences",
    "sequence_batches",
]

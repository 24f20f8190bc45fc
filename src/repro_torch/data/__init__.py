"""The synthetic LM data pipeline, its shards assigned to hosts by
BinomialHash — the counterpart of ``repro.data``."""

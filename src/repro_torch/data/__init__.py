"""Data pipelines (port of `repro.data`): `data.synthetic`, the
deterministic synthetic LM stream."""

"""Serving engines (port of `repro.serve`; slice 1 has the policy engine)."""

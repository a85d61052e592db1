"""Fixed-point formats, range monitors and QAT state (port of `repro.core`)."""

"""Configurations of the port's workloads (port of `repro.configs`)."""

"""Runtime pieces shared by the port's engines (port of `repro.runtime`)."""

"""Adam and FIXAR's fixed-point Adam (port of `repro.optim`)."""

"""Training-side engines (port of `repro.train`): `train.learner`, the
learner engine.  `train/step.py` (the LM train step) belongs to the LM zoo
and is not ported yet."""

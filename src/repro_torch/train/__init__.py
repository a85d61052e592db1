"""Training-side engines (port of `repro.train`): `train.step`, the LM
train step (QAT, microbatches, Adam), and `train.learner`, the learner
engine."""

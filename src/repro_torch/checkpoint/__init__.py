"""Checkpointing (port of `repro.checkpoint`): `ckpt.save` / `restore` /
`latest_step` / `prune` and `ckpt.AsyncCheckpointer`."""

"""Launch-side helpers of the port (port of `repro.launch`): the mesh
builders.  The reference's `specs`, `train` and `dryrun` are not ported
(ROADMAP queue 1)."""

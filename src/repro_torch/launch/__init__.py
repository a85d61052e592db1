"""Launch-side helpers of the port (port of `repro.launch`): the mesh
builders (`mesh`), the input, state and cache shapes with their shardings
(`specs`) and the LM training driver (`train`).  The reference's `dryrun`
(XLA lowering over 512 forced host devices) is left out (ROADMAP queue 1)."""

"""Launch-side helpers of the port (port of `repro.launch`): the mesh
builders and the process group (`mesh`), the input, state and cache shapes
with their shardings (`specs`), the LM training driver (`train`) and the
dry-run cells (`dryrun`: each cell run once on the live process group,
where the reference lowers it for 256 or 512 forced host devices)."""

"""The data axis across processes: ``multihost`` (the process group),
``mesh`` (meshes and per-process slabs) and ``shard`` (the reductions)."""

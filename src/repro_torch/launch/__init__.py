"""Launchers of the port: the serving CLI (``python -m
repro_torch.launch.serve``). The reference's training launcher, dry run,
meshes and roofline tools have no counterpart yet."""

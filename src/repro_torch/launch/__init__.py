"""Launchers of the port: the serving CLI (``python -m
repro_torch.launch.serve``) and the training CLI (``python -m
repro_torch.launch.train``). The reference's dry run, meshes and roofline
tools have no counterpart yet."""

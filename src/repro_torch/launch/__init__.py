"""Launchers of the port: ``serve`` (batched prefill + greedy decode).
Mirrors ``src/repro/launch/``; the trainer, dry-run and roofline wait for
their slices."""

"""Launchers of the port: ``serve`` (batched prefill + greedy decode),
``train`` (the training driver) and ``dryrun`` (each cell's step counted
on meta tensors: ``op_cost``, with the H100 roofline of
``roofline_math``; ``mesh``: the reference's mesh shapes).  Mirrors
``src/repro/launch/``, with ``op_cost`` in place of ``hlo_cost``."""

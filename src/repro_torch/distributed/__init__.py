"""Query meshes of the port (mirrors ``src/repro/distributed/__init__.py``,
less ``sharding``, which belongs to the MoE models and is not ported)."""
from .mesh import (DATA, MODEL, POD, QueryMesh, dp_size, make_query_mesh,
                   mesh_axis_size, tp_size)

__all__ = ["DATA", "MODEL", "POD", "QueryMesh", "dp_size",
           "make_query_mesh", "mesh_axis_size", "tp_size"]

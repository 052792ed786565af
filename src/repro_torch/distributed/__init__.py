"""Query meshes of the port, and the dry-run's sharding rules
(``sharding``: logical axes -> mesh axes).  Mirrors
``src/repro/distributed/__init__.py``."""
from .mesh import (DATA, MODEL, POD, QueryMesh, dp_size, make_query_mesh,
                   mesh_axis_size, tp_size)

__all__ = ["DATA", "MODEL", "POD", "QueryMesh", "dp_size",
           "make_query_mesh", "mesh_axis_size", "tp_size"]

"""Vertica core on torch: projections, encodings, storage, MVCC, K-safety.

Mirrors ``src/repro/core/__init__.py`` (with the torch decode and upload
in place of the jax ones); adds ``carry`` (state_of /
database_from_state).
"""
from .block_cache import BlockCache, CacheStats
from .carry import database_from_state, state_of
from .catalog import Catalog
from .database import (AvailabilityError, NodeState, QueryRejectedError,
                       RecoverySourceLostError, SegmentUnavailableError,
                       Txn, VerticaDB)
from .encodings import (EncodedColumn, Encoding, decode_torch, device_bytes,
                        encode, upload_torch)
from .epochs import EpochManager
from .faults import (INJECTION_POINTS, CrashNode, FaultError,
                     FaultInjector, FaultTimeout, Hang, NodeCrashError,
                     NullInjector, Transient, TransientFaultError,
                     fire_with_retries, with_retries)
from .locks import COMPATIBLE, CONVERT, MODES, LockError, LockManager
from .partitioning import partition_keys
from .projection import (PrejoinSpec, ProjectionDef, super_projection)
from .segmentation import SegmentationSpec, hash_columns, rebalance_plan
from .sma import ColumnSMA
from .storage import DeleteVector, ROSContainer, WOS
from .tuple_mover import ProjectionStore, mergeout, moveout, run_tuple_mover
from .types import BLOCK_ROWS, ColumnDef, SQLType, TableSchema

__all__ = [
    "AvailabilityError", "BLOCK_ROWS", "BlockCache", "COMPATIBLE",
    "CONVERT", "CacheStats", "Catalog",
    "ColumnDef", "ColumnSMA", "CrashNode", "DeleteVector", "EncodedColumn",
    "Encoding", "EpochManager", "FaultError", "FaultInjector",
    "INJECTION_POINTS",
    "FaultTimeout", "Hang", "LockError", "LockManager", "MODES",
    "NodeCrashError", "NodeState", "NullInjector", "PrejoinSpec",
    "ProjectionDef", "ProjectionStore", "QueryRejectedError",
    "ROSContainer", "RecoverySourceLostError", "SQLType",
    "SegmentUnavailableError", "SegmentationSpec", "TableSchema",
    "Transient", "TransientFaultError", "Txn", "VerticaDB", "WOS",
    "database_from_state", "decode_torch", "device_bytes", "encode",
    "fire_with_retries", "hash_columns", "mergeout", "moveout",
    "partition_keys", "rebalance_plan", "run_tuple_mover", "state_of",
    "super_projection", "upload_torch", "with_retries",
]

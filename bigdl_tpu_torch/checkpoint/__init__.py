"""Asynchronous, fault-tolerant checkpointing (port of
``bigdl_tpu/checkpoint``): atomic, checksummed ``.npz`` v3 snapshots in the
reference's wire and tree layout (:mod:`.snapshot`), retention,
latest-valid discovery and exact resume (:mod:`.manager`), the schema
checked on resume (:mod:`.schema`) and SIGTERM/SIGINT preemption
(:mod:`.preemption`)."""

from bigdl_tpu_torch.checkpoint.manager import CheckpointManager
from bigdl_tpu_torch.checkpoint.preemption import PreemptionHandler
from bigdl_tpu_torch.checkpoint.schema import (SchemaMismatchError,
                                               build_schema, diff_schemas,
                                               schema_hash, validate_schema)
from bigdl_tpu_torch.checkpoint.snapshot import (AsyncSnapshotWriter,
                                                 SnapshotError,
                                                 capture_to_host,
                                                 load_snapshot, read_manifest,
                                                 verify_snapshot,
                                                 write_snapshot)

__all__ = [
    "CheckpointManager", "PreemptionHandler", "AsyncSnapshotWriter",
    "SnapshotError", "SchemaMismatchError", "build_schema", "diff_schemas",
    "schema_hash", "validate_schema", "capture_to_host", "load_snapshot",
    "read_manifest", "verify_snapshot", "write_snapshot",
]

"""Distributed runtime of the port (counterpart of emox/comm): process init
on torch.distributed, the collectives and their transports
(`runtime`), and the sharding rules of the data x context x model mesh
(`sharding`), whose collectives the port calls where GSPMD inserts them for
the reference.
"""

from emox_torch.comm.runtime import ProcessInfo, initialize_distributed, is_master, process_info
from emox_torch.comm.sharding import batch_spec, param_shardings, shard_batch, with_context_sharding

__all__ = [
    "ProcessInfo",
    "initialize_distributed",
    "process_info",
    "is_master",
    "batch_spec",
    "param_shardings",
    "shard_batch",
    "with_context_sharding",
]

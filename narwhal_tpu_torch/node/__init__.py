from .node import spawn_primary_node, spawn_worker_node

__all__ = ["spawn_primary_node", "spawn_worker_node"]

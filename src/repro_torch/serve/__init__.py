"""Serving: the continuous-batching LM scheduler and the multi-query bbox
server."""

from .query_scheduler import SpatialQuery, SpatialQueryServer
from .scheduler import BatchedServer, Request

__all__ = ["BatchedServer", "Request", "SpatialQuery", "SpatialQueryServer"]

"""Serving: the continuous-batching LM scheduler."""

from .scheduler import BatchedServer, Request

__all__ = ["BatchedServer", "Request"]

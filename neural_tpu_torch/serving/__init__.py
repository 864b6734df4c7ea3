"""Continuous-batching serving: the Scheduler and the threaded ModelServer."""
from .scheduler import Scheduler, Sequence, SeqStatus
from .server import ModelServer, Query

__all__ = ["Scheduler", "Sequence", "SeqStatus", "ModelServer", "Query"]

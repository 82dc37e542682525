"""Behavioural re-implementations of the logs Arcadia is evaluated
against (§5): PMDK's libpmemlog, FLEX, and Query Fresh.  Each reproduces
the *design characteristics* the paper attributes to it (lock scope,
flush schedule, integrity checking, replication model) on top of the
same simulated PMEM device, so microbenchmark comparisons measure design
differences rather than implementation noise."""

from .pmdk_log import PMDKLog
from .flex_log import FlexLog
from .query_fresh import QueryFreshLog

__all__ = ["PMDKLog", "FlexLog", "QueryFreshLog"]

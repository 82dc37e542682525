"""The harness: the cells' data found by name, the run, the trace."""

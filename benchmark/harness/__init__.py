"""The benchmark's general code: the spec, the traffic driver, the trace
reading, and the run of one cell."""

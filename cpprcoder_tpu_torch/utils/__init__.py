"""Host-side tooling of the port: per-phase profiling counters."""

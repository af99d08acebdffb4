"""Program-build guards (counterpart of the JAX package's ``analysis/``;
only ``guards.RetraceGuard`` and ``guards.RetraceError`` are ported)."""

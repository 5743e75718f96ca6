"""Runtime pieces of the port: deterministic fault injection."""

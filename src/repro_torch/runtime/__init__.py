"""Single-device execution: the engine factory and its caches."""

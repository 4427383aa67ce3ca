"""Serving runtime on a mesh of ranks or one device: admission, dispatch (engine cache and
the two-phase hybrid) and the synchronous scheduler façade."""

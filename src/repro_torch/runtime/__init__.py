"""Serving runtime on one device: admission, dispatch (engine cache and
the two-phase hybrid) and the synchronous scheduler façade."""

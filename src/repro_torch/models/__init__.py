"""Models of the port: ``transformer`` (the LM family's forward, loss
value, prefill and decode)."""

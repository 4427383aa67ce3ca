"""Models of the port: ``transformer`` (the LM family's forward, the
training loss and its gradient path, prefill and decode) and ``gnn`` (the
GNN family: SchNet, PNA, MACE, EquiformerV2 and their substrate)."""

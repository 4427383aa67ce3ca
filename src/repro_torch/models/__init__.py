"""Models of the port: ``transformer`` (the LM family's forward, the
training loss and its gradient path, prefill and decode), ``gnn`` (the
GNN family: SchNet, PNA, MACE, EquiformerV2 and their substrate) and
``dcn_v2`` (recsys: DCN-v2's forward, loss and retrieval)."""

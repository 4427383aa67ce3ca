"""The GNN family (port of ``repro.models.gnn``): the message-passing
substrate (``common``), SchNet, PNA, the irreps machinery and the two
equivariant models, MACE and EquiformerV2."""

"""Block-sparse SpMM kernel (GNN sum/mean aggregation)."""

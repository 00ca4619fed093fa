"""Models of the GNN and recsys families: ``gnn/*`` and ``din``; each an
``nn.Module`` whose ``state_dict`` keys are the reference's parameter paths
(``params``)."""

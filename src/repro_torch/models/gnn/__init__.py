"""The four GNN architectures on one shared substrate (``common``)."""
